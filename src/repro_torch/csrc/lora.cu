// NanoAdapter (LoRA) residual kernels for Hopper (sm_90a):
//   y = x + scale * (x A) B, math in fp32, one cast to x's dtype at the end.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/lora/lora.py::lora_residual_2d          (_kernel, line 29)
//   src/repro/kernels/lora/lora.py::grouped_lora_residual_2d  (_grouped_kernel, line 78)
//
// What bounds it on an H100: the work is 4*T*D*r fp32 operations over
// 2*T*D*sizeof(x) + 2*D*r*4 bytes. At the prefill shape (T = 128, D = 4096,
// r = 64, bf16 x) that is 134 MFLOP against 4.2 MB: 2.0 us at the 67 TFLOP/s
// fp32 rate of the CUDA cores, 1.25 us at 3.35 TB/s, so the fp32 operations
// bound the CUDA-core design, narrowly. The tensor-core design below does
// 2.5x those operations (five TF32 products) at 495 TFLOP/s: 0.68 us, so
// bytes bound it. At the decode shape (8 rows) the adapter bytes bound it.
// chip_smoke.py computes the bounds for every shape it times.
//
// Two designs, chosen by dtype at the C entry point (no fallback between
// them). Both keep the rank-r intermediate out of the output path and pass
// it through an fp32 scratch (T, kSplit, r) that the wrapper allocates.
//
// * f32 x, and the grouped kernel in both dtypes (down_chunk / up_cols):
//   kRows = 8 rows a block, fp32 FMAs on the CUDA cores (tensor-core
//   products cannot hold the f32 path's 1e-6). Pass 1, grid (row tiles,
//   kSplit d-chunks), writes partial h per chunk to the scratch; pass 2,
//   grid (row tiles, column blocks), sums the partials in a fixed order and
//   computes y = x + h B for kCols columns.
//
// * bf16 x, single adapter (the main path; namespace tc): tensor cores in
//   TF32 with f32 accumulation (mma.sync.m16n8k8), f32 accuracy kept by
//   splitting operands: bf16 x is exact in TF32; an f32 operand v becomes
//   hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), together v to about 2^-22.
//   x·A = x·A_hi + x·A_lo (two products); h·B = h_hi·B_hi + h_hi·B_lo +
//   h_lo·B_hi (three; h_lo·B_lo is below f32's last bit). Adapters rounded to
//   bf16 or one TF32 product would drop 13 or 16 mantissa bits of the f32
//   adapters FedNano trains and merges. Each f32 operand tile is split once
//   per block in shared memory, not once per warp. Three launches:
//   pass 1, grid (64-row tiles, splits of D, groups of 16 rank columns),
//           4 warps of 16 rows; x and A stream through a ring of four
//           cp.async stages of 64 d (16-byte copies when the shapes allow,
//           else 4-byte copies or element loads; ragged T, D and r are
//           zero-filled) into partial h per split. D is split into up to
//           kSplit chunks so that a call has about four blocks per SM: at
//           T = 128 two row tiles alone would leave most SMs idle, and the
//           tensor-core work of one block per 256 d was the first design's
//           limit;
//   sum,    when D was split: h = the partials summed in split order, in
//           place in split slot 0 (once, not once per pass-2 block as the
//           first design did; a thread-block cluster summing them over
//           distributed shared memory capped the split at 8 and was slower);
//   pass 2, grid (64-row tiles, 64-column blocks), 8 warps; copies h, its
//           B columns and its x tile (the residual) with cp.async, then
//           writes bf16 rows with 16-byte stores.
//   ref.py's lora_residual_split_tf32 models the arithmetic.
//
// The f32 single-adapter kernel and the grouped kernel push each row through
// the same device functions, whose fp32 operations for a row depend only on
// that row, A and B (explicit __fmaf_rn / __fadd_rn / __fmul_rn, no
// contraction left to the compiler, no atomics).
// So a row of a mixed-tenant batch equals the single-adapter kernel's row bit
// for bit in fp32, the property lora.py:72-74 pins for the TPU kernel.

#include <algorithm>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 8;            // rows of x per block
constexpr int kSplit = 16;          // d-chunks of the down-projection; lora/ops.py::SPLIT
constexpr int kCols = kThreads;     // output columns per pass-2 block
constexpr int kMaxRank = kThreads;  // pass 1 gives each rank column >= 1 thread

// rows_s[i] = row index of slot i of this tile, or -1 when the slot is idle
// (past the end, or another adapter's row). Block-uniform answer: any row?
__device__ __forceinline__ bool select_rows(const int* __restrict__ idx, int n_rows, int n,
                                            int* rows_s) {
  if (threadIdx.x < kRows) {
    const int row = blockIdx.x * kRows + threadIdx.x;
    rows_s[threadIdx.x] = (row < n_rows && (idx == nullptr || idx[row] == n)) ? row : -1;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) any = any || rows_s[i] >= 0;
  return any;
}

// Pass 1: partial[row][s][:] = x[row, chunk s] · A[chunk s, :].
template <typename T>
__device__ __forceinline__ void down_chunk(const T* __restrict__ x, const float* __restrict__ A,
                                           float* __restrict__ partial, const int* rows_s, int D,
                                           int r, int s) {
  __shared__ float red[kRows][kThreads];
  const int t = threadIdx.x;
  const int groups = kThreads / r;  // thread (g, j) sums d = d0 + g, d0 + g + groups, ...
  const int chunk = (D + kSplit - 1) / kSplit;
  const int d0 = s * chunk, d1 = min(D, d0 + chunk);
  if (t < groups * r) {
    const int g = t / r, j = t % r;
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int d = d0 + g; d < d1; d += groups) {
      const float a = A[(int64_t)d * r + j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = rows_s[i];
        if (row >= 0) acc[i] = __fmaf_rn(to_f32(x[(int64_t)row * D + d]), a, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) red[i][g * r + j] = acc[i];
  }
  __syncthreads();
  for (int e = t; e < kRows * r; e += kThreads) {
    const int i = e / r, j = e % r, row = rows_s[i];
    if (row >= 0) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum = __fadd_rn(sum, red[i][g * r + j]);
      partial[((int64_t)row * kSplit + s) * r + j] = sum;
    }
  }
}

// Pass 2: h = sum over s of the partials, out[row, c] = x[row, c] + scale * (h · B)[c].
template <typename T>
__device__ __forceinline__ void up_cols(const T* __restrict__ x, const float* __restrict__ B,
                                        const float* __restrict__ partial, T* __restrict__ out,
                                        const int* rows_s, int D, int r, float scale) {
  __shared__ float h[kRows][kMaxRank];
  const int t = threadIdx.x;
  for (int e = t; e < kRows * r; e += kThreads) {
    const int i = e / r, j = e % r, row = rows_s[i];
    float sum = 0.f;
    if (row >= 0) {
      for (int s = 0; s < kSplit; ++s) sum = __fadd_rn(sum, partial[((int64_t)row * kSplit + s) * r + j]);
    }
    h[i][j] = sum;
  }
  __syncthreads();
  const int c = blockIdx.y * kCols + t;
  if (c >= D) return;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < r; ++j) {
    const float b = B[(int64_t)j * D + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = __fmaf_rn(h[i][j], b, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = rows_s[i];
    if (row >= 0) {
      const int64_t o = (int64_t)row * D + c;
      out[o] = from_f32<T>(__fadd_rn(to_f32(x[o]), __fmul_rn(scale, acc[i])));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_down_kernel(const T* __restrict__ x, const float* __restrict__ A,
                     float* __restrict__ partial, int n_rows, int D, int r) {
  __shared__ int rows_s[kRows];
  if (!select_rows(nullptr, n_rows, 0, rows_s)) return;
  down_chunk<T>(x, A, partial, rows_s, D, r, blockIdx.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_up_kernel(const T* __restrict__ x, const float* __restrict__ B,
                   const float* __restrict__ partial, T* __restrict__ out, int n_rows, int D,
                   int r, float scale) {
  __shared__ int rows_s[kRows];
  if (!select_rows(nullptr, n_rows, 0, rows_s)) return;
  up_cols<T>(x, B, partial, out, rows_s, D, r, scale);
}

// Grouped: grid.z = adapter n. Block (tile, ., n) serves the rows of its tile
// that selected adapter n and skips both products when there are none.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_down_kernel(const T* __restrict__ x, const float* __restrict__ A,
                        const int* __restrict__ idx, float* __restrict__ partial, int n_rows,
                        int D, int r) {
  __shared__ int rows_s[kRows];
  const int n = blockIdx.z;
  if (!select_rows(idx, n_rows, n, rows_s)) return;
  down_chunk<T>(x, A + (int64_t)n * D * r, partial, rows_s, D, r, blockIdx.y);
}

// Blocks of adapter 0 also copy the rows whose id lies outside [0, N) through
// as x, bit for bit (the identity slot of the serving bank).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_up_kernel(const T* __restrict__ x, const float* __restrict__ B,
                      const int* __restrict__ idx, const float* __restrict__ partial,
                      T* __restrict__ out, int n_rows, int D, int r, int N, float scale) {
  __shared__ int rows_s[kRows];
  const int n = blockIdx.z;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (n == 0 && c < D) {
    for (int i = 0; i < kRows; ++i) {
      const int row = blockIdx.x * kRows + i;
      if (row < n_rows && (idx[row] < 0 || idx[row] >= N)) {
        out[(int64_t)row * D + c] = x[(int64_t)row * D + c];
      }
    }
  }
  if (!select_rows(idx, n_rows, n, rows_s)) return;
  up_cols<T>(x, B + (int64_t)n * r * D, partial, out, rows_s, D, r, scale);
}

// ---------------------------------------------------------------------------
// bf16 x, single adapter: tensor cores in split TF32 (see the note at the top)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // rows of x per block
constexpr int kThreads = 256;    // pass 2: 8 warps, 4 row groups of 16 x 2 column groups
constexpr int kDownThreads = 128;  // pass 1: 4 warps of 16 rows
constexpr int kNB = 16;          // rank columns per pass-1 block
constexpr int kSubD = 64;        // d of x and A per pass-1 stage
constexpr int kStages = 4;       // pass-1 stages in flight: a whole 256-d chunk
constexpr int kCols = 64;        // output columns per pass-2 block

constexpr size_t kDownSmem =  // the ring of x and A stages, then A's lo halves
    kStages * (sizeof(bf16) * kRows * (kSubD + 8) + sizeof(float) * kSubD * (kNB + 8)) +
    sizeof(float) * kSubD * (kNB + 8);
template <int RP>
constexpr size_t up_smem() {  // h, B's hi and lo halves, x
  return sizeof(float) * (kRows * (RP + 4) + 2 * RP * (kCols + 8)) +
         sizeof(bf16) * kRows * (kCols + 8);
}

// x[row0 .. row0 + 64, c0 .. c0 + n) -> xs (row stride ld), zero outside
// [0, T) x [c0, c_end). 16-byte cp.async when vec (D % 8 == 0 and aligned,
// so an 8-column chunk is wholly in or out), else element loads.
__device__ __forceinline__ void stage_x(bf16* xs, int ld, const bf16* __restrict__ x, int row0,
                                        int T, int D, int c0, int n, int c_end, bool vec) {
  if (vec) {
    const int ch = n / 8;
    for (int e = threadIdx.x; e < kRows * ch; e += blockDim.x) {
      const int i = e / ch, c = (e % ch) * 8, row = row0 + i, col = c0 + c;
      const bool ok = row < T && col < c_end;
      repro::cp_async16(xs + i * ld + c, ok ? x + (int64_t)row * D + col : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * n; e += blockDim.x) {
      const int i = e / n, c = e % n, row = row0 + i, col = c0 + c;
      xs[i * ld + c] = (row < T && col < c_end) ? x[(int64_t)row * D + col] : __float2bfloat16(0.f);
    }
  }
}

// M[r0 .. r0 + nr, c0 .. c0 + nc) of an f32 matrix with row stride ldm ->
// ms (row stride ld), zero outside [0, r_end) x [0, c_end). 16-byte copies
// when vec (c_end % 4 == 0 and aligned), else 4-byte copies.
__device__ __forceinline__ void stage_f32(float* ms, int ld, const float* __restrict__ M,
                                          int64_t ldm, int r0, int nr, int r_end, int c0, int nc,
                                          int c_end, bool vec) {
  if (vec) {
    const int ch = nc / 4;
    for (int e = threadIdx.x; e < nr * ch; e += blockDim.x) {
      const int i = e / ch, c = (e % ch) * 4, row = r0 + i, col = c0 + c;
      const bool ok = row < r_end && col < c_end;
      repro::cp_async16(ms + i * ld + c, ok ? M + row * ldm + col : M, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
      const int i = e / nc, c = e % nc, row = r0 + i, col = c0 + c;
      const bool ok = row < r_end && col < c_end;
      repro::cp_async4(ms + i * ld + c, ok ? M + row * ldm + col : M, ok);
    }
  }
}

// Split an (nr, nc) f32 tile in place into its TF32 hi halves, its lo
// halves into lo (same layout), once per block rather than once per warp.
__device__ __forceinline__ void split_tile(float* hi, float* lo, int ld, int nr, int nc) {
  for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
    const int o = (e / nc) * ld + e % nc;
    uint32_t h, l;
    repro::split_tf32(hi[o], h, l);
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

// Pass 1, grid (row tiles, splits of D, groups of kNB rank columns):
// partial[row][s][group's columns] = x[rows, chunk s] · A[chunk s, group's
// columns] as x·hi + x·lo (x is exact in TF32), x and A streamed through a
// ring of kStages cp.async stages. With one split this is h itself.
__global__ void __launch_bounds__(kDownThreads)
    down_kernel(const bf16* __restrict__ x, const float* __restrict__ A,
                float* __restrict__ partial, int T, int D, int r, int chunk, bool vec_x,
                bool vec_a) {
  constexpr int LDX = kSubD + 8, LDA = kNB + 8;
  constexpr int X_STAGE = kRows * LDX, A_STAGE = kSubD * LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                  // [kStages][kRows][LDX]
  float* as = reinterpret_cast<float*>(xs + kStages * X_STAGE);  // [kStages][kSubD][LDA], then hi
  float* alo = as + kStages * A_STAGE;                           // [kSubD][LDA]

  const int row0 = blockIdx.x * kRows, s = blockIdx.y, j0 = blockIdx.z * kNB;
  const int d0 = s * chunk, d1 = min(D, d0 + chunk);
  const int n_sub = (d1 - d0 + kSubD - 1) / kSubD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int wr = warp * 16;

  auto stage = [&](int it) {  // an empty commit group past the end keeps the count
    if (it < n_sub) {
      const int buf = it % kStages, dd = d0 + it * kSubD;
      stage_x(xs + buf * X_STAGE, LDX, x, row0, T, D, dd, kSubD, d1, vec_x);
      stage_f32(as + buf * A_STAGE, LDA, A, r, dd, kSubD, d1, j0, kNB, r, vec_a);
    }
    repro::cp_async_commit();
  };
  float acc[2][4] = {};
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) stage(it);
  for (int it = 0; it < n_sub; ++it) {
    stage(it + kStages - 1);
    repro::cp_async_wait<kStages - 1>();
    __syncthreads();
    float* ahi = as + (it % kStages) * A_STAGE;
    split_tile(ahi, alo, LDA, kSubD, kNB);
    __syncthreads();
    const bf16* xt = xs + (it % kStages) * X_STAGE + wr * LDX;
#pragma unroll
    for (int kk = 0; kk < kSubD; kk += 8) {
      const uint32_t a[4] = {
          __float_as_uint(__bfloat162float(xt[g * LDX + kk + t4])),
          __float_as_uint(__bfloat162float(xt[(g + 8) * LDX + kk + t4])),
          __float_as_uint(__bfloat162float(xt[g * LDX + kk + t4 + 4])),
          __float_as_uint(__bfloat162float(xt[(g + 8) * LDX + kk + t4 + 4]))};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int o0 = (kk + t4) * LDA + n * 8 + g, o1 = o0 + 4 * LDA;
        repro::mma_tf32(acc[n], a, __float_as_uint(ahi[o0]), __float_as_uint(ahi[o1]));
        repro::mma_tf32(acc[n], a, __float_as_uint(alo[o0]), __float_as_uint(alo[o1]));
      }
    }
    __syncthreads();  // readers of this stage and of alo are done before refills
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + wr + g + (e >= 2 ? 8 : 0), j = j0 + n * 8 + 2 * t4 + (e & 1);
      if (row < T && j < r) partial[((int64_t)row * kSplit + s) * r + j] = acc[n][e];
    }
  }
}

// Between the passes, when D was split: h[row][0][j] = the splits' partials
// summed in split order, in place in slot 0 (one thread owns an element).
__global__ void __launch_bounds__(256)
    sum_splits_kernel(float* __restrict__ partial, int T, int r, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)T * r) return;
  float* p = partial + (e / r) * kSplit * r + e % r;
  float v[kSplit];
#pragma unroll
  for (int s = 0; s < kSplit; ++s) v[s] = s < splits ? p[s * r] : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kSplit; ++s) sum += v[s];
  p[0] = sum;
}

// Pass 2, grid (row tiles, column blocks): out = x + scale · (h_hi·B_hi +
// h_hi·B_lo + h_lo·B_hi), h read from split slot 0 of the scratch.
template <int RP>
__global__ void __launch_bounds__(kThreads)
    up_kernel(const bf16* __restrict__ x, const float* __restrict__ B,
              const float* __restrict__ h_in, bf16* __restrict__ out, int T, int D, int r,
              float scale, bool vec_x, bool vec_b, bool vec_h) {
  constexpr int COLS = kCols;
  constexpr int LDH = RP + 4, LDB = COLS + 8, LDX = COLS + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);      // [kRows][LDH]
  float* bs = hs + kRows * LDH;                        // [RP][LDB], then hi
  float* blo = bs + RP * LDB;                          // [RP][LDB]
  bf16* xs = reinterpret_cast<bf16*>(blo + RP * LDB);  // [kRows][LDX]

  const int row0 = blockIdx.x * kRows, c0 = blockIdx.y * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * (COLS / 2);

  stage_f32(bs, LDB, B, D, 0, RP, r, c0, COLS, D, vec_b);
  stage_x(xs, LDX, x, row0, T, D, c0, COLS, D, vec_x);
  stage_f32(hs, LDH, h_in, (int64_t)kSplit * r, row0, kRows, T, 0, RP, r, vec_h);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  split_tile(bs, blo, LDB, RP, COLS);
  __syncthreads();

  constexpr int NTW = COLS / 16;
  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* ht = hs + wr * LDH;
#pragma unroll 2
  for (int kk = 0; kk < RP; kk += 8) {
    uint32_t ah[4], al[4];
    repro::split_tf32(ht[g * LDH + kk + t4], ah[0], al[0]);
    repro::split_tf32(ht[(g + 8) * LDH + kk + t4], ah[1], al[1]);
    repro::split_tf32(ht[g * LDH + kk + t4 + 4], ah[2], al[2]);
    repro::split_tf32(ht[(g + 8) * LDH + kk + t4 + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int o0 = (kk + t4) * LDB + wc + n * 8 + g, o1 = o0 + 4 * LDB;
      const uint32_t b0h = __float_as_uint(bs[o0]), b1h = __float_as_uint(bs[o1]);
      repro::mma_tf32(acc[n], ah, b0h, b1h);
      repro::mma_tf32(acc[n], ah, __float_as_uint(blo[o0]), __float_as_uint(blo[o1]));
      repro::mma_tf32(acc[n], al, b0h, b1h);
    }
  }
  // residual in f32, one rounding to bf16, in place in xs (each element is
  // read and written by the one lane that owns it)
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bf16* p = xs + (wr + g + (e >= 2 ? 8 : 0)) * LDX + wc + n * 8 + 2 * t4 + (e & 1);
      *p = __float2bfloat16_rn(__fadd_rn(__bfloat162float(*p), __fmul_rn(scale, acc[n][e])));
    }
  }
  __syncthreads();
  if (vec_x) {
    constexpr int ch = COLS / 8;
    for (int e = threadIdx.x; e < kRows * ch; e += kThreads) {
      const int i = e / ch, c = (e % ch) * 8, row = row0 + i, col = c0 + c;
      if (row < T && col < D) {
        *reinterpret_cast<uint4*>(out + (int64_t)row * D + col) =
            *reinterpret_cast<const uint4*>(xs + i * LDX + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kRows * COLS; e += kThreads) {
      const int i = e / COLS, c = e % COLS, row = row0 + i, col = c0 + c;
      if (row < T && col < D) out[(int64_t)row * D + col] = xs[i * LDX + c];
    }
  }
}

template <int RP>
int launch(const bf16* x, const float* A, const float* B, float* scratch, bf16* out, int T,
           int D, int r, float scale, cudaStream_t stream) {
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kDownSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(up_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)up_smem<RP>());
    }
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // About four pass-1 blocks per SM: split D into up to kSplit chunks,
  // each a whole number of kSubD stages.
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  const int tiles = (T + kRows - 1) / kRows, groups = (r + kNB - 1) / kNB;
  const int want = std::max(1, std::min(kSplit, (4 * sms + tiles * groups - 1) / (tiles * groups)));
  const int chunk = ((D + want - 1) / want + kSubD - 1) / kSubD * kSubD;
  const int splits = (D + chunk - 1) / chunk;
  const bool vec_x = D % 8 == 0 && repro::aligned16(x) && repro::aligned16(out);
  const bool vec_a = r % 4 == 0 && repro::aligned16(A);
  const bool vec_b = D % 4 == 0 && repro::aligned16(B);
  const bool vec_h = r % 4 == 0 && repro::aligned16(scratch);
  down_kernel<<<dim3(tiles, splits, groups), kDownThreads, kDownSmem, stream>>>(
      x, A, scratch, T, D, r, chunk, vec_x, vec_a);
  if (splits > 1) {
    const int64_t n = (int64_t)T * r;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(scratch, T, r, splits);
  }
  up_kernel<RP><<<dim3(tiles, (D + kCols - 1) / kCols), kThreads, up_smem<RP>(), stream>>>(
      x, B, scratch, out, T, D, r, scale, vec_x, vec_b, vec_h);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const float* A, const float* B, float* scratch, void* out, int T,
             int D, int r, float scale, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (r <= 16) return launch<16>(xb, A, B, scratch, ob, T, D, r, scale, stream);
  if (r <= 32) return launch<32>(xb, A, B, scratch, ob, T, D, r, scale, stream);
  if (r <= 64) return launch<64>(xb, A, B, scratch, ob, T, D, r, scale, stream);
  if (r <= 128) return launch<128>(xb, A, B, scratch, ob, T, D, r, scale, stream);
  return launch<256>(xb, A, B, scratch, ob, T, D, r, scale, stream);
}

}  // namespace tc

bool bad_shape(int n_rows, int D, int r, int64_t scratch_floats) {
  return r < 1 || r > kMaxRank || D < 1 || (int64_t)n_rows * kSplit * r > scratch_floats;
}

}  // namespace

// scratch: fp32, at least n_rows * kSplit * r floats.
extern "C" int repro_lora_residual(const void* x, const float* A, const float* B, float* scratch,
                                   long long scratch_floats, void* out, int n_rows, int D, int r,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  const int tiles = (n_rows + kRows - 1) / kRows;
  const dim3 g1(tiles, kSplit), g2(tiles, (D + kCols - 1) / kCols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    const float* xf = static_cast<const float*>(x);
    lora_down_kernel<float><<<g1, kThreads, 0, s>>>(xf, A, scratch, n_rows, D, r);
    lora_up_kernel<float><<<g2, kThreads, 0, s>>>(xf, B, scratch, static_cast<float*>(out),
                                                  n_rows, D, r, scale);
  } else if (dtype == repro::kBF16) {
    return tc::dispatch(x, A, B, scratch, out, n_rows, D, r, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_grouped_lora_residual(const void* x, const float* A, const float* B,
                                           const int* idx, float* scratch,
                                           long long scratch_floats, void* out, int n_rows, int D,
                                           int r, int N, float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats) || N < 1 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  const int tiles = (n_rows + kRows - 1) / kRows;
  const dim3 g1(tiles, kSplit, N), g2(tiles, (D + kCols - 1) / kCols, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    const float* xf = static_cast<const float*>(x);
    grouped_down_kernel<float><<<g1, kThreads, 0, s>>>(xf, A, idx, scratch, n_rows, D, r);
    grouped_up_kernel<float><<<g2, kThreads, 0, s>>>(xf, B, idx, scratch,
                                                     static_cast<float*>(out), n_rows, D, r, N,
                                                     scale);
  } else if (dtype == repro::kBF16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    grouped_down_kernel<__nv_bfloat16><<<g1, kThreads, 0, s>>>(xb, A, idx, scratch, n_rows, D, r);
    grouped_up_kernel<__nv_bfloat16><<<g2, kThreads, 0, s>>>(
        xb, B, idx, scratch, static_cast<__nv_bfloat16*>(out), n_rows, D, r, N, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
