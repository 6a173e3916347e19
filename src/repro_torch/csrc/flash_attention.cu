// Flash-attention forward for Hopper (sm_90a), with the per-row logsumexp.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (_kernel, line 32; pallas_call, line 121).
//
// Same function: online-softmax attention with fp32 running max m, sum l and
// accumulator; GQA (query head h reads KV head h / (H / Hkv)); causal, sliding
// window and tanh softcap; keys at kpos >= Sk masked; query i at absolute
// position (Sk - Sq) + i; rows that see no key give 0 and lse = m + log(1e-30)
// with m = NEG_INF as the marker (flash_attention.py:57-84).
//
// What bounds it on an H100: at the prefill shape (B = 1, S = 192, H = 32,
// D = 128, bf16, causal) the function needs 4*D operations per unmasked
// (query, key) pair, about 0.3 GFLOP, and moves about 6.3 MB: 1.9 us at
// 3.35 TB/s, 0.3 us at the bf16 tensor-core rate, so device memory bounds it.
//
// Two designs, chosen by dtype at the C entry point (no fallback between them):
//
// * f32 (the parity tests' 1e-6 path): one block per (query tile of kBQ
//   rows, head, batch). The TPU grid's sequential k axis becomes a loop over
//   K/V tiles of kBK keys staged in shared memory as fp32, products as fp32
//   FMAs on the CUDA cores. Tensor-core products (TF32, bf16) cannot hold 1e-6.
//   Tiles that the causal or window mask hides entirely are not visited (in
//   both designs): on the TPU they are exact no-ops (alpha = 1, p = 0), so
//   skipping them changes no bit of the result.
//
// * bf16 (the main path): flash_fwd_bf16, tensor cores. One block of 4 warps
//   per (64 query rows, head, batch); each warp owns 16 rows. Q is copied
//   once into shared memory with 16-byte cp.async; K and V tiles of 64 keys
//   stay bf16 in shared memory (rows padded by 16 bytes, so ldmatrix hits
//   every bank once) in a two-stage ring: the copy of tile i + 1 is in flight
//   while tile i is multiplied. S = Q K^T and O += P V run as
//   mma.sync.m16n8k16 bf16 with f32 accumulation, fed by ldmatrix (V through
//   ldmatrix.trans). mma.sync, not wgmma: the S accumulator's register layout
//   is exactly the A-operand layout P needs for the second product, so P
//   never leaves registers, and a 16-row warp tile keeps D = 256's
//   accumulator at 128 registers a thread; the price is about half of
//   wgmma's issue rate, which PERF.md weighs against SDPA on the main path's
//   short sequences (at most three 64-key tiles a block at S = 192). The
//   online softmax runs in registers on log2-scaled scores (scale * log2(e)
//   folded into one multiply, exp2f), each row reduced across its quad of
//   lanes with shuffles; masks are evaluated only on tiles that cross the
//   diagonal, the window edge or Sk. The running max, the sum l and the
//   accumulator are f32; l and the LSE sum the f32 p. The one arithmetic
//   difference from the TPU kernel: P is rounded to bf16 before P V (the TPU
//   kernel multiplies f32 p). ref.py's attention_bf16_model models that
//   rounding; PERF.md gives its measured size. The output goes through
//   shared memory and out with 16-byte stores.
//   Grid (H, B, query tiles) with causal tiles in reverse, so the blocks
//   with the most keys start first. 64-row tiles: measured on the
//   H100 (PERF.md), 32-row tiles, which double the blocks where 64-row ones
//   leave SMs idle (96 blocks at the prefill shape), were slower at both
//   main-path shapes, and longest-first was as fast as or faster than
//   in-order launch.
//
// Rows that see no key are handled as on the TPU in both designs.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kBQ = 16;       // query rows per block
constexpr int kBK = 32;       // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kNegInf = -2.0e38f;

template <int D>
constexpr size_t smem_bytes() {
  // q and k rows padded by one float: the score loop reads k rows of
  // different keys at one d, which would otherwise hit one bank.
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kBK + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);     // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);     // [kBK][D]
  float* ps = vs + kBK * D;           // [kBQ][kBK] scores, then probabilities
  float* m_s = ps + kBQ * kBK;        // [kBQ] running max
  float* l_s = m_s + kBQ;             // [kBQ] running sum
  float* alpha_s = l_s + kBQ;         // [kBQ] rescale of this tile

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hkv);
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = Sk - Sq;

  for (int e = t; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    qs[i * (D + 1) + d] = qi < Sq ? to_f32(q[(((int64_t)b * Sq + qi) * H + h) * D + d]) : 0.f;
  }
  if (t < kBQ) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }

  // Accumulator ownership: thread t holds columns d0 + c*TPR of rows rg + m*RG.
  constexpr int TPR = D < kThreads ? D : kThreads;
  constexpr int RG = kThreads / TPR;
  constexpr int NC = D / TPR;
  constexpr int NR = kBQ / RG;
  const int d0 = t % TPR, rg = t / TPR;
  float acc[NR][NC];
#pragma unroll
  for (int mr = 0; mr < NR; ++mr)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[mr][c] = 0.f;

  // Score ownership: thread t scores key j = t % kBK against rows i0 + m*SR.
  constexpr int SR = kThreads / kBK;
  constexpr int NSR = kBQ / SR;
  const int sj = t % kBK, si0 = t / kBK;

  // Keys any real row of this tile can see.
  const int q_last = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int e = t; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kj < Sk) {
        const int64_t off = (((int64_t)b * Sk + kj) * Hkv + kh) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j * (D + 1) + d] = kk;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    {
      float s[NSR];
#pragma unroll
      for (int m = 0; m < NSR; ++m) s[m] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = ks[sj * (D + 1) + d];
#pragma unroll
        for (int m = 0; m < NSR; ++m) s[m] = fmaf(qs[(si0 + m * SR) * (D + 1) + d], kd, s[m]);
      }
#pragma unroll
      for (int m = 0; m < NSR; ++m) {
        const int i = si0 + m * SR;
        float sc = s[m] * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        const int qpos = q0 + i + q_offset, kpos = k0 + sj;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        ps[i * kBK + sj] = ok ? sc : kNegInf;
      }
    }
    __syncthreads();

    if (t < kBQ) {
      float* row = ps + t * kBK;
      const float m_prev = m_s[t];
      float m_cur = kNegInf;
      for (int j = 0; j < kBK; ++j) m_cur = fmaxf(m_cur, row[j]);
      const float m_new = fmaxf(m_prev, m_cur);
      const bool dead = m_new <= kNegInf * 0.5f;  // no unmasked key yet
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = dead ? 0.f : expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      const float alpha = m_prev <= kNegInf * 0.5f ? 0.f : expf(m_prev - m_new);
      l_s[t] = l_s[t] * alpha + sum;
      m_s[t] = m_new;
      alpha_s[t] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int mr = 0; mr < NR; ++mr) {
      const int i = rg + mr * RG;
      const float al = alpha_s[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + c * TPR;
        float a = acc[mr][c] * al;
        for (int j = 0; j < kBK; ++j) a = fmaf(ps[i * kBK + j], vs[j * D + d], a);
        acc[mr][c] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int mr = 0; mr < NR; ++mr) {
    const int i = rg + mr * RG, qi = q0 + i;
    if (qi < Sq) {
      const float denom = fmaxf(l_s[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        out[(((int64_t)b * Sq + qi) * H + h) * D + d0 + c * TPR] = from_f32<T>(acc[mr][c] / denom);
      }
    }
  }
  if (t < kBQ && q0 + t < Sq) {
    lse[((int64_t)b * Sq + q0 + t) * H + h] = m_s[t] + logf(fmaxf(l_s[t], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int Hkv, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Sk, H, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                      int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
                      float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window, softcap, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window, softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window, softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcBK = 64;     // keys per K/V tile
constexpr int kKVStages = 2;  // K/V tiles in the shared-memory ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTcW = 4;       // warps a block, 16 query rows each

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(16 * kTcW + 2 * kKVStages * kTcBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kTcW * 32)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Sk, int H, int Hkv, int causal, int window, float softcap,
                   float scale) {
  constexpr int BQ = 16 * kTcW, NT = 32 * kTcW;
  constexpr int LD = D + 8;      // shared row stride in elements (16 bytes of padding)
  constexpr int CH = D / 8;      // 16-byte chunks in a row
  constexpr int NS = kTcBK / 8;  // n-tiles of S
  constexpr int NO = D / 8;      // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                       // [kKVStages][kTcBK][LD]
  bf16* vs = ks + kKVStages * kTcBK * LD;        // [kKVStages][kTcBK][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;  // longest first
  const int kh = h / (H / Hkv);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const bf16* qb = q + ((int64_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((int64_t)b * Sk * Hkv + kh) * D;
  const bf16* vb = v + ((int64_t)b * Sk * Hkv + kh) * D;

  for (int e = tid; e < BQ * CH; e += NT) {
    const int i = e / CH, c = e % CH, qi = q0 + i;
    repro::cp_async16(qs + i * LD + c * 8, qi < Sq ? qb + qi * q_stride + c * 8 : q, qi < Sq);
  }

  // Keys any real row of this tile can see, in whole 64-key tiles.
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int k_first = (k_begin / kTcBK) * kTcBK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kTcBK - 1) / kTcBK : 0;

  auto load_kv = [&](int it) {  // tile it, or an empty group past the end
    if (it < n_tiles) {
      const int k0 = k_first + it * kTcBK;
      bf16* kd = ks + (it % kKVStages) * kTcBK * LD;
      bf16* vd = vs + (it % kKVStages) * kTcBK * LD;
      for (int e = tid; e < kTcBK * CH; e += NT) {
        const int j = e / CH, c = e % CH, kj = k0 + j;
        const bool ok = kj < Sk;
        repro::cp_async16(kd + j * LD + c * 8, ok ? kb + kj * kv_stride + c * 8 : k, ok);
        repro::cp_async16(vd + j * LD + c * 8, ok ? vb + kj * kv_stride + c * 8 : v, ok);
      }
    }
    repro::cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < kKVStages - 1; ++it) load_kv(it);  // with Q in the first group

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // log2 units, rows g and g + 8
  float l_run[2] = {0.f, 0.f};          // this lane's share of the row sums

  const int g = lane / 4, t4 = lane % 4;
  const int row_g = q0 + warp * 16 + g;  // query row of c[0..1]; c[2..3] are row_g + 8
  const bf16* qw = qs + warp * 16 * LD;
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kTcBK, stage = it % kKVStages;
    load_kv(it + kKVStages - 1);
    repro::cp_async_wait<kKVStages - 1>();
    __syncthreads();
    const bf16* kt = ks + stage * kTcBK * LD;
    const bf16* vt = vs + stage * kTcBK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, qw + (lane % 16) * LD + kk + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        repro::ldmatrix_x4(bk, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kk +
                                   ((lane / 8) % 2) * 8);
        repro::mma_bf16(s[2 * np], a, bk[0], bk[1]);
        repro::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale (and cap) into log2 units; mask only tiles that cross an edge
    const bool edge = k0 + kTcBK > Sk || (causal && k0 + kTcBK - 1 > q0 + q_offset) ||
                      (window > 0 && q0 + BQ - 1 + q_offset - k0 >= window);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * qk_scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap * kLog2e;
        if (edge) {
          const int qpos = row_g + (e >= 2 ? 8 : 0) + q_offset;
          const int kpos = k0 + n * 8 + 2 * t4 + (e & 1);
          bool ok = kpos < Sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && (qpos - kpos < window);
          if (!ok) x = kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax, rows g (r = 0) and g + 8 (r = 1)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const bool dead = m_new <= kNegInf * 0.5f;  // no unmasked key yet
      alpha[r] = m_run[r] <= kNegInf * 0.5f ? 0.f : exp2f(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = dead ? 0.f : exp2f(s[n][2 * r + c] - m_new);
          s[n][2 * r + c] = p;
          sum += p;
        }
      }
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 as the A operand straight from registers
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      const uint32_t a[4] = {repro::pack_bf16(s[2 * j][0], s[2 * j][1]),
                             repro::pack_bf16(s[2 * j][2], s[2 * j][3]),
                             repro::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             repro::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, vt + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                         dp * 16 + (lane / 16) * 8);
        repro::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        repro::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  // Q's copy when no tile was visited, and the empty groups. The barrier keeps
  // another warp's Q copy from landing in qs after this warp writes O there.
  repro::cp_async_wait<0>();
  __syncthreads();

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[r] = l;
    denom[r] = fmaxf(l, 1e-30f);
  }
  // this warp's 16 rows of O through its own rows of qs, then 16-byte stores
  bf16* ow = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(ow + g * LD + col) =
        repro::pack_bf16(o[n][0] / denom[0], o[n][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * LD + col) =
        repro::pack_bf16(o[n][2] / denom[1], o[n][3] / denom[1]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int i = e / CH, c = e % CH, qi = q0 + warp * 16 + i;
    if (qi < Sq) {
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + qi) * H + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(ow + i * LD + c * 8);
    }
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row_g + 8 * r;
      if (qi < Sq) {
        const bool dead = m_run[r] <= kNegInf * 0.5f;
        lse[((int64_t)b * Sq + qi) * H + h] =
            dead ? kNegInf + logf(1e-30f) : m_run[r] * kLn2 + logf(l_run[r]);
      }
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Sk, int H, int Hkv, int causal, int window, float softcap,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles = (Sq + 16 * kTcW - 1) / (16 * kTcW);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, tiles);
  flash_fwd_bf16<D><<<grid, kTcW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, Sq, Sk, H, Hkv, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

int dispatch_bf16(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                  int B, int Sq, int Sk, int H, int Hkv, int causal, int window, float softcap,
                  float scale, cudaStream_t stream) {
  if (!repro::aligned16(q) || !repro::aligned16(k) || !repro::aligned16(v) ||
      !repro::aligned16(out)) {
    return (int)cudaErrorMisalignedAddress;  // 16-byte copies and stores
  }
  switch (D) {
    case 32:
      return launch_bf16<32>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window,
                                  softcap, scale, stream);
    case 64:
      return launch_bf16<64>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window,
                                  softcap, scale, stream);
    case 128:
      return launch_bf16<128>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window,
                                   softcap, scale, stream);
    case 256:
      return launch_bf16<256>(q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window,
                                   softcap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Sk, Hkv, D), out (B, Sq, H, D), lse (B, Sq, H) fp32;
// window <= 0 means no window, softcap <= 0 no cap.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, int window, float softcap, float scale,
                                     int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv != 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    return dispatch_head_dim<float>(D, q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window,
                                    softcap, scale, s);
  }
  if (dtype == repro::kBF16) {
    return dispatch_bf16(D, q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal, window, softcap,
                         scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
