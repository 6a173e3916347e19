// Mamba2 SSD chunked scan for Hopper (sm_90a):
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t . h_t
//
// computed in chunks of Q steps, as the TPU kernel does. Per chunk, with
// L = cumsum(dt A) over the chunk:
//   intra  y_i  = sum_{j<=i} exp(L_i - L_j) (C_i . B_j) dt_j x_j
//   inter  y_i += exp(L_i) C_i . h
//   state  h    = exp(L_last) h + sum_j exp(L_last - L_j) B_j (dt_j x_j)^T
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_chunked_pallas  (_kernel, line 26)
//
// Shapes: x (Bt, S, H, P) and dt (Bt, S, H) in f32 or bf16, A (H,) f32,
// B and C (Bt, S, N); y like x. Q = min(chunk, S); the ragged last chunk is
// read as zeros (dt = 0 there: decay 1, update 0), so nothing is padded in
// memory. x, B and C may be strided views over time and batch (the model
// passes slices of one projection); their last axes are contiguous.
//
// What bounds it on an H100: operations. At mamba2-130m's widths (H = 24,
// P = 64, N = 128, Q = 256) a chunk costs about 2 Q^2 N / 2 for C.B^T,
// 2 Q^2 P / 2 for the masked product with x, and 2 Q N P each for the
// carried state's read (every chunk but the first, where h = 0) and update
// (every chunk but the last, whose state nothing reads), against a few bytes
// per step: far above the card's operations-per-byte line. chip_smoke.py
// computes the bound.
//
// Design. The TPU kernel walks the grid (b, h, chunk) in order and keeps a
// whole chunk in VMEM: x, B, C, the (Q, Q) score tile and h, about 600 KB in
// f32 at Q = 256, beyond the 227 KB a block may have here. So one block owns
// one (b, h) and walks its chunks in a loop, h (N x P f32, 32 KB) resident
// in shared memory for the whole sequence. Each chunk is cut into 64-row
// query tiles and 64-column key tiles: C^T and B^T tiles (n-major, row
// stride 65 so that the transposing stores hit 32 banks) and one (64, 64)
// score tile live in shared memory at a time, about 131 KB in all. Each
// thread owns a 4 x 4 block of scores and of outputs (rows ty + 16a,
// columns tx + 16b), accumulated in f32 registers with FMAs on the CUDA
// cores. Scores above the diagonal are selected to 0 BEFORE any exponential
// (L_i - L_j > 0 there and exp could overflow; inf * 0 would be NaN), and
// key tiles wholly above the diagonal are skipped. The cumulative sum L is
// one thread's sequential f32 loop of round-to-nearest products and sums.
//
// Left for later (ROADMAP performance work): C.B^T depends on b and the
// chunk but not on the head (one group), so it could be formed once for all
// 24 heads; the chunk loop could split into a parallel state pass and an
// output pass; the products could run on tensor cores (wgmma, TF32 or
// bf16). At batch 1 this grid is 24 blocks on 132 SMs.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kTile = 64;       // query rows and key columns per sub-tile
constexpr int kLd = kTile + 1;  // row stride of the transposed tiles and the score tile
constexpr int kMaxN = 128;      // state width the register blocking covers (16 x 8)
constexpr int kMaxP = 64;       // head width the register blocking covers (16 x 4)

inline size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P            // h
         + 2 * (size_t)N * kLd    // C^T and B^T tiles
         + (size_t)kTile * P      // dt * x tile
         + (size_t)kTile * kLd    // score tile
         + 2 * (size_t)Q;         // dt and L of the chunk
}

template <typename T>
__device__ __forceinline__ void load_transposed(float* __restrict__ dst, const T* __restrict__ src,
                                                long long st, int t0, int rows, int S, int N) {
  // dst[n * kLd + i] = src[(t0 + i) * st + n], zero beyond the chunk or S.
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int i = e / N, n = e - i * N;
    const int t = t0 + i;
    dst[n * kLd + i] = (i < rows && t < S) ? to_f32(src[(long long)t * st + n]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void load_xdt(float* __restrict__ dst, const T* __restrict__ x,
                                         long long st, const float* __restrict__ dt_chunk,
                                         int t0, int rows, int S, int P) {
  // dst[j * P + p] = x[t0 + j, p] * dt[t0 + j] (dt_chunk is relative to t0)
  for (int e = threadIdx.x; e < kTile * P; e += kThreads) {
    const int j = e / P, p = e - j * P;
    const int t = t0 + j;
    dst[e] = (j < rows && t < S) ? __fmul_rn(to_f32(x[(long long)t * st + p]), dt_chunk[j])
                                 : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ out, int S, int H, int P, int N,
                    int Q, long long x_sb, long long x_st, long long b_sb, long long b_st,
                    long long c_sb, long long c_st) {
  extern __shared__ float smem[];
  float* h_s = smem;                     // (N, P)
  float* ct_s = h_s + N * P;             // (N, kLd): C^T of a query tile
  float* bt_s = ct_s + N * kLd;          // (N, kLd): B^T of a key tile
  float* xd_s = bt_s + N * kLd;          // (kTile, P): dt * x of a key tile
  float* s_s = xd_s + kTile * P;         // (kTile, kLd): masked, decayed scores
  float* dt_s = s_s + kTile * kLd;       // (Q,)
  float* l_s = dt_s + Q;                 // (Q,)

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a_h = A[hh];
  const T* xb = x + (long long)b * x_sb + (long long)hh * P;
  const T* bb = Bm + (long long)b * b_sb;
  const T* cb = Cm + (long long)b * c_sb;

  for (int e = tid; e < N * P; e += kThreads) h_s[e] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    __syncthreads();  // the previous chunk's readers of dt_s / l_s are done
    for (int i = tid; i < Q; i += kThreads) {
      const int t = t0 + i;
      dt_s[i] = t < S ? to_f32(dt[((long long)b * S + t) * H + hh]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(dt_s[i], a_h));
        l_s[i] = run;
      }
    }
    __syncthreads();

    // ---- outputs, one query tile at a time (h_s holds the state before the chunk)
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int rows = min(kTile, Q - i0);
      load_transposed(ct_s, cb, c_st, t0 + i0, rows, S, N);
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
      // inter: exp(L_i) * C_i . h (h = 0 before the first chunk)
      if (c > 0) {
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ct_s[n * kLd + ty + 16 * a];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            hv[q] = p < P ? h_s[n * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] = __fmaf_rn(cv[a], hv[q], acc[a][q]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
          const float e = i < rows ? expf(l_s[i0 + i]) : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = __fmul_rn(acc[a][q], e);
        }
      }

      // intra: key tiles at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int cols = min(kTile, Q - j0);
        load_transposed(bt_s, bb, b_st, t0 + j0, cols, S, N);
        load_xdt(xd_s, xb, x_st, dt_s + j0, t0 + j0, cols, S, P);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[a][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = ct_s[n * kLd + ty + 16 * a];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = bt_s[n * kLd + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) sc[a][q] = __fmaf_rn(cv[a], bv[q], sc[a][q]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = tx + 16 * q;
            // select before the exponential: above the diagonal L_i - L_j > 0
            const bool keep = i < rows && j < cols && j0 + j <= i0 + i;
            s_s[i * kLd + j] =
                keep ? __fmul_rn(sc[a][q], expf(l_s[i0 + i] - l_s[j0 + j])) : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < cols; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = s_s[(ty + 16 * a) * kLd + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int p = tx + 16 * q;
            xv[q] = p < P ? xd_s[j * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] = __fmaf_rn(sv[a], xv[q], acc[a][q]);
        }
        __syncthreads();  // bt_s, xd_s and s_s are rewritten by the next key tile
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a, t = t0 + i0 + i;
        if (i >= rows || t >= S) continue;
        T* row = out + (((long long)b * S + t) * H + hh) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < P) row[p] = from_f32<T>(acc[a][q]);
        }
      }
      __syncthreads();  // ct_s is rewritten by the next query tile
    }

    // ---- state: h = exp(L_last) h + sum_j exp(L_last - L_j) B_j (dt_j x_j)^T,
    // which only a later chunk reads (y is the only output)
    if (c + 1 == n_chunks) break;
    const float l_last = l_s[Q - 1];
    const float decay = expf(l_last);
    float hacc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        hacc[a][q] = (n < N && p < P) ? __fmul_rn(decay, h_s[n * P + p]) : 0.f;
      }
    }
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int cols = min(kTile, Q - j0);
      load_transposed(bt_s, bb, b_st, t0 + j0, cols, S, N);
      load_xdt(xd_s, xb, x_st, dt_s + j0, t0 + j0, cols, S, P);
      __syncthreads();
      for (int j = 0; j < cols; ++j) {
        const float w = expf(l_last - l_s[j0 + j]);
        float bv[8], xv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int n = ty + 16 * a;
          bv[a] = n < N ? __fmul_rn(w, bt_s[n * kLd + j]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          xv[q] = p < P ? xd_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) hacc[a][q] = __fmaf_rn(bv[a], xv[q], hacc[a][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int n = ty + 16 * a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tx + 16 * q;
        if (n < N && p < P) h_s[n * P + p] = hacc[a][q];
      }
    }
    // the next chunk's first __syncthreads orders these writes before any read
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* B, const void* C,
           void* out, int Bt, int S, int H, int P, int N, int Q, long long x_sb, long long x_st,
           long long b_sb, long long b_st, long long c_sb, long long c_st, cudaStream_t s) {
  const size_t bytes = smem_floats(N, P, Q) * sizeof(float);
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  // Raised once per instantiation to the card's limit; the attribute is not a
  // stream operation, so launches inside a CUDA graph capture stay legal.
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(H, Bt);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(out), S, H, P, N, Q, x_sb, x_st, b_sb, b_st,
      c_sb, c_st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssd_scan(const void* x, const void* dt, const float* A, const void* B,
                              const void* C, void* out, int Bt, int S, int H, int P, int N,
                              int Q, long long x_sb, long long x_st, long long b_sb,
                              long long b_st, long long c_sb, long long c_st, int dtype,
                              void* stream) {
  if (Bt < 0 || S < 0 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      (S > 0 && Q > S))
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || S == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(x, dt, A, B, C, out, Bt, S, H, P, N, Q, x_sb, x_st, b_sb, b_st, c_sb,
                         c_st, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, out, Bt, S, H, P, N, Q, x_sb, x_st, b_sb,
                                 b_st, c_sb, c_st, s);
  return (int)cudaErrorInvalidValue;
}
