// Flash-attention backward for Hopper (sm_90a), bf16 on the tensor cores:
// dq, dk and dv from the forward's saved output and per-row logsumexp.
//
// Replaces no Pallas kernel: the JAX package's backward
//   src/repro/kernels/flash_attention/ops.py::_fa_bwd
// is plain jnp, which XLA fuses on the TPU. Its straight port
// (kernels/flash_attention/ref.py::attention_bwd) upcasts q, k, v, o and dO to
// f32, repeats K/V per head and builds the whole (B, H, Sq, Sk) score matrix
// and three more of its size; on the H100 its five f32 products run on the
// CUDA cores and its element-wise passes move 3.2 GB tensors at a 2,048-token
// row (48 heads, batch 4). It took over half of a long-row training step.
// This kernel is the f32 path's function for bf16 inputs, with the rounding
// ref.attention_bwd_bf16_model writes down; f32 inputs (the 1e-6 parity
// tests) keep the plain backward.
//
// What bounds it on an H100: per unmasked (query, key) pair the backward
// needs 5 products of 2·D operations (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), and moves only q, k, v, o, dO, the LSE and the
// three gradients. At a 2,048-token causal row (B 4, H 48 on 8 KV heads,
// D 128) that is 0.52 TFLOP against 0.47 GB, 0.52 ms at the bf16 peak and
// 0.14 ms at 3.35 TB/s: the tensor cores bound it, not memory. This
// design recomputes S and dP once more for dQ so that no block writes
// another's output: no atomics, no partial sums in device memory, the same
// bits on every call. dS enters its two products as hi + lo, two bf16
// halves (about 16 bits of mantissa): with dS rounded to bf16 alone, the
// long-row training cell's AdamW moments read 0.0078 against the plain
// reference on one seed, 87 % of their 0.009 limit (PERF.md). With
// the recompute and the split the kernels run 18·D operations a pair.
//
// Three launches, in stream order:
//
// * flash_bwd_prep_bf16: one warp a query row. delta = rowsum(dO ∘ O) in f32
//   (the D-trick's row term), and the LSE in log2 units (+inf for a row that
//   sees no key, whose LSE carries the NEG_INF marker, so exp2 gives p = 0),
//   both (B, H, Sq_pad) f32 scratch that the wrapper allocates, rows past Sq
//   padded (delta 0, +inf) so the two main kernels load whole tiles unguarded.
//
// * flash_bwd_dkdv_bf16: one block of 4 warps per (64 keys, KV head, batch),
//   each warp owning 16 keys. K and V are copied once into shared memory; the
//   block then walks every query head of its GQA group and, for each, the
//   query tiles that the causal or window mask leaves visible (tiles the mask
//   hides are not visited, as in the forward), Q and dO tiles in a two-stage
//   cp.async ring. Per tile and per 32-query chunk, on mma.sync m16n8k16 bf16
//   with f32 accumulation, in the transposed frame (keys are the rows):
//   dP^T = V dO^T, S^T = K Q^T, then in f32 registers P = exp2(S·scale·log2e −
//   LSE2) (tanh softcap first, its (1 − t²) kept as the chain factor) and
//   dS = P ∘ (dP − delta) ∘ (1 − t²); dV += P^T dO with P rounded to bf16 and
//   dK += dS^T Q with dS as hi + lo, straight from the accumulator registers
//   (an accumulator's layout is the next product's A operand).
//   dK and dV stay in f32 registers across the whole group loop, so the GQA
//   sum over the group's heads happens in the block and each is written once,
//   in bf16, through shared memory with 16-byte stores. Blocks run in key-tile
//   order, which under the causal mask is longest first.
//   Head dim 256: dK and dV of 16 keys x 256 columns would take 256 f32
//   registers a thread, so the block accumulates a 128-column half of them
//   (the grid's third axis carries the half) and recomputes S and dP for each
//   half; its query tiles are 32 rows to keep the shared memory at 135 KB.
//
// * flash_bwd_dq_bf16: one block of 4 warps per (64 query rows, head, batch),
//   each warp owning 16 rows, the forward's layout: Q and dO copied once, K and
//   V tiles in a two-stage ring over the visible key tiles; S = Q K^T and
//   dP = dO V^T recomputed, dS as above, dQ += dS K (dS as hi + lo) in f32
//   registers; 32-key tiles at head dim 256 (dQ alone takes 128 registers
//   there). Grid (H, B, query tiles), causal tiles in reverse: longest first.
//
// The f32 accumulators are scaled by D^-0.5 once, at the end. Shared rows are
// padded by 16 bytes, so ldmatrix hits every bank once at every head dim
// (rows of 40, 72, 88, 136 and 264 elements: an odd number of 16-byte chunks).
// Masks are evaluated only on tile pairs that cross the diagonal, the window
// edge or Sk; queries past Sq are zero rows with LSE2 = +inf, so they add
// nothing to dK and dV.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -2.0e38f;
constexpr int kW = 4;          // warps a block in both main kernels, 16 rows each
constexpr int kNT = kW * 32;   // threads a block
constexpr int kPrepRows = 8;   // query rows (warps) a prep block
constexpr int kRowPad = 64;    // the scratch's rows are padded to this (ops.py::BWD_ROW_PAD)

template <int D>
struct DkDvTiles {
  static constexpr int BK = 16 * kW;            // keys a block
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows a staged tile
  static constexpr int QC = 32;                 // query columns a register chunk
  static constexpr int DC = D > 128 ? 128 : D;  // dK/dV columns a block accumulates
  static constexpr int LD = D + 8;              // shared row stride (elements)
  static constexpr size_t smem() {
    return sizeof(bf16) * (size_t)(2 * BK + 4 * BQ) * LD + sizeof(float) * 4 * BQ;
  }
};

template <int D>
struct DqTiles {
  static constexpr int BQ = 16 * kW;            // query rows a block
  static constexpr int BK = D > 128 ? 32 : 64;  // keys a staged tile
  static constexpr int LD = D + 8;
  static constexpr size_t smem() { return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * LD; }
};

// delta = rowsum(dO ∘ O) and LSE2 = LSE·log2(e) (+inf: no key, or past Sq),
// rows (b, h, qi) of the (B, H, Sq_pad) scratch, one warp a row.
template <int D>
__global__ void __launch_bounds__(kPrepRows * 32)
    flash_bwd_prep_bf16(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        float* __restrict__ lse2, int Sq, int Sq_pad, int H, int64_t rows) {
  constexpr int CH = D / 8;  // 16-byte chunks a row (at most 32)
  const int64_t row = (int64_t)blockIdx.x * kPrepRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int qi = (int)(row % Sq_pad);
  const int64_t bh = row / Sq_pad;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  float acc = 0.f, l2 = __int_as_float(0x7f800000);  // +inf
  if (qi < Sq) {
    const int64_t off = ((b * Sq + qi) * H + h) * D;
    if (lane < CH) {
      const uint4 ov = *reinterpret_cast<const uint4*>(out + off + lane * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + lane * 8);
      const bf16* o8 = reinterpret_cast<const bf16*>(&ov);
      const bf16* g8 = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(o8[e]), __bfloat162float(g8[e]), acc);
    }
#pragma unroll
    for (int m = 16; m >= 1; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    const float l = lse[(b * Sq + qi) * H + h];
    l2 = l > kNegInf * 0.5f ? l * kLog2e : __int_as_float(0x7f800000);
  }
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = l2;
  }
}

// Scaled (and capped) score in log2 units, with the softcap's chain factor.
__device__ __forceinline__ float log2_score(float s, float qk_scale, float softcap, float& fac) {
  float x = s * qk_scale;
  fac = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(x / softcap);
    x = t * softcap * kLog2e;
    fac = 1.f - t * t;
  }
  return x;
}

// (a, b) = hi + lo to about 2^-16 relative: hi = bf16(a, b), lo = bf16 of
// the remainders, each a packed pair (the A-operand halves of dS).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, int causal, int window) {
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  return ok;
}

// this warp's 16 rows x N columns of an f32 accumulator, times `mul`, as bf16
// into `stage` (row stride LD), then 16-byte stores to dst rows (stride
// `stride`) below `limit`
template <int NO, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], float mul, bf16* stage,
                                           bf16* dst, int64_t stride, int row0, int limit,
                                           int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + g * LD + col) =
        repro::pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + col) =
        repro::pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int CH = NO;  // 8 columns an n-tile: one 16-byte chunk
  for (int e = lane; e < 16 * CH; e += 32) {
    const int i = e / CH, c = e % CH;
    if (row0 + i < limit) {
      *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + i) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + i * LD + c * 8);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kNT)
    flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ delta, const float* __restrict__ lse2,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int Sq_pad,
                        int H, int Hkv, int causal, int window, float softcap, float scale) {
  static_assert(D % 16 == 0, "the bf16 kernels step over D in 16s");
  using T = DkDvTiles<D>;
  constexpr int BK = T::BK, BQ = T::BQ, QC = T::QC, DC = T::DC, LD = T::LD;
  constexpr int CH = D / 8;     // 16-byte chunks a row
  constexpr int NQ = QC / 8;    // n-tiles of a chunk of S^T and dP^T
  constexpr int NO = DC / 8;    // n-tiles of dK and dV
  constexpr int NCHUNK = D / DC;
  static_assert(BQ % QC == 0 && D % DC == 0 && DC % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* qs = vs + BK * LD;                       // [2][BQ][LD]
  bf16* gs = qs + 2 * BQ * LD;                   // [2][BQ][LD] dO
  float* ls = reinterpret_cast<float*>(gs + 2 * BQ * LD);  // [2][BQ] LSE2
  float* dls = ls + 2 * BQ;                                // [2][BQ] delta

  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = (blockIdx.z / NCHUNK) * BK, c0 = (blockIdx.z % NCHUNK) * DC;
  const int G = H / Hkv;
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const bf16* kb = k + ((int64_t)b * Sk * Hkv + kh) * D;
  const bf16* vb = v + ((int64_t)b * Sk * Hkv + kh) * D;

  for (int e = tid; e < BK * CH; e += kNT) {
    const int j = e / CH, c = e % CH, kj = k0 + j;
    const bool ok = kj < Sk;
    repro::cp_async16(ks + j * LD + c * 8, ok ? kb + kj * kv_stride + c * 8 : k, ok);
    repro::cp_async16(vs + j * LD + c * 8, ok ? vb + kj * kv_stride + c * 8 : v, ok);
  }

  // Query rows that see any key of this tile, in whole BQ-row tiles.
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;  // exclusive
  const int q_first = (q_lo / BQ) * BQ;
  const int n_qt = q_hi > q_first ? (q_hi - q_first + BQ - 1) / BQ : 0;
  const int steps = G * n_qt;  // (head of the group, query tile), head-major

  auto load_q = [&](int i) {  // step i, or an empty group past the end
    if (i < steps) {
      const int h = kh * G + i / n_qt, q0 = q_first + (i % n_qt) * BQ;
      const int st = i % 2;
      bf16* qd = qs + st * BQ * LD;
      bf16* gd = gs + st * BQ * LD;
      const bf16* qb = q + ((int64_t)b * Sq * H + h) * D;
      const bf16* gb = dout + ((int64_t)b * Sq * H + h) * D;
      for (int e = tid; e < BQ * CH; e += kNT) {
        const int r = e / CH, c = e % CH, qi = q0 + r;
        const bool ok = qi < Sq;
        repro::cp_async16(qd + r * LD + c * 8, ok ? qb + qi * q_stride + c * 8 : q, ok);
        repro::cp_async16(gd + r * LD + c * 8, ok ? gb + qi * q_stride + c * 8 : dout, ok);
      }
      const int64_t srow = ((int64_t)b * H + h) * Sq_pad + q0;  // q0 + BQ <= Sq_pad
      for (int e = tid; e < 2 * (BQ / 4); e += kNT) {
        const int which = e / (BQ / 4), c = e % (BQ / 4);
        float* dst = (which ? dls : ls) + st * BQ + c * 4;
        repro::cp_async16(dst, (which ? delta : lse2) + srow + c * 4, true);
      }
    }
    repro::cp_async_commit();
  };
  load_q(0);  // with K and V in the first group

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;
  const bf16* kw = ks + warp * 16 * LD;
  const bf16* vw = vs + warp * 16 * LD;
  const int key_g = k0 + warp * 16 + g;  // key of accumulator rows c[0..1]; c[2..3] are + 8

  for (int i = 0; i < steps; ++i) {
    load_q(i + 1);
    repro::cp_async_wait<1>();
    __syncthreads();
    const int st = i % 2, q0 = q_first + (i % n_qt) * BQ;
    const bf16* qt = qs + st * BQ * LD;
    const bf16* gt = gs + st * BQ * LD;
    const float* lt = ls + st * BQ;
    const float* dt = dls + st * BQ;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + q_offset) ||
                      (window > 0 && q0 + BQ - 1 + q_offset - k0 >= window);

#pragma unroll 1
    for (int qc = 0; qc < BQ; qc += QC) {
      // dP^T = V dO^T and S^T = K Q^T: 16 keys x QC queries a warp
      float dp[NQ][4], s[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t av[4], ak[4];
        repro::ldmatrix_x4(av, vw + (lane % 16) * LD + kk + (lane / 16) * 8);
        repro::ldmatrix_x4(ak, kw + (lane % 16) * LD + kk + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int r = qc + np * 16 + lane % 8 + (lane / 16) * 8, c = kk + ((lane / 8) % 2) * 8;
          uint32_t bg[4], bq[4];
          repro::ldmatrix_x4(bg, gt + r * LD + c);
          repro::ldmatrix_x4(bq, qt + r * LD + c);
          repro::mma_bf16(dp[2 * np], av, bg[0], bg[1]);
          repro::mma_bf16(dp[2 * np + 1], av, bg[2], bg[3]);
          repro::mma_bf16(s[2 * np], ak, bq[0], bq[1]);
          repro::mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
        }
      }
      // P and dS in f32; s becomes P, dp becomes dS
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + n * 8 + 2 * t4 + (e & 1);
          float fac;
          const float x = log2_score(s[n][e], qk_scale, softcap, fac);
          float p = exp2f(x - lt[col]);
          if (edge && !visible(q0 + col + q_offset, key_g + (e >= 2 ? 8 : 0), Sk, causal, window))
            p = 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dt[col]) * fac;
        }
      }
      // dV += P^T dO with P rounded to bf16, dK += dS^T Q with dS as hi + lo
      // (two bf16 products), straight from the registers as A operands
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        const uint32_t ap[4] = {repro::pack_bf16(s[2 * j][0], s[2 * j][1]),
                                repro::pack_bf16(s[2 * j][2], s[2 * j][3]),
                                repro::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                repro::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* src = dp[2 * j + f / 2] + 2 * (f % 2);
          split_bf16(src[0], src[1], ah[f], al[f]);
        }
        const int r = qc + j * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int dd = 0; dd < DC / 16; ++dd) {
          const int c = c0 + dd * 16 + (lane / 16) * 8;
          uint32_t bg[4], bq[4];
          repro::ldmatrix_x4_trans(bg, gt + r * LD + c);
          repro::ldmatrix_x4_trans(bq, qt + r * LD + c);
          repro::mma_bf16(dva[2 * dd], ap, bg[0], bg[1]);
          repro::mma_bf16(dva[2 * dd + 1], ap, bg[2], bg[3]);
          repro::mma_bf16(dka[2 * dd], ah, bq[0], bq[1]);
          repro::mma_bf16(dka[2 * dd + 1], ah, bq[2], bq[3]);
          repro::mma_bf16(dka[2 * dd], al, bq[0], bq[1]);
          repro::mma_bf16(dka[2 * dd + 1], al, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // K and V (or their copies, when no step ran) are no longer read

  const int row0 = k0 + warp * 16;
  store_rows<NO, LD>(dka, scale, ks + warp * 16 * LD,
                     dk + ((int64_t)b * Sk * Hkv + kh) * D + c0, kv_stride, row0, Sk, lane);
  store_rows<NO, LD>(dva, 1.f, vs + warp * 16 * LD,
                     dv + ((int64_t)b * Sk * Hkv + kh) * D + c0, kv_stride, row0, Sk, lane);
}

template <int D>
__global__ void __launch_bounds__(kNT)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ delta, const float* __restrict__ lse2,
                      bf16* __restrict__ dq, int Sq, int Sk, int Sq_pad, int H, int Hkv,
                      int causal, int window, float softcap, float scale) {
  static_assert(D % 16 == 0, "the bf16 kernels step over D in 16s");
  using T = DqTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD;
  constexpr int CH = D / 8;
  constexpr int NS = BK / 8;  // n-tiles of S and dP
  constexpr int NO = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* gs = qs + BQ * LD;                       // [BQ][LD] dO
  bf16* ks = gs + BQ * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;  // longest first
  const int kh = h / (H / Hkv);
  const int q_offset = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const bf16* qb = q + ((int64_t)b * Sq * H + h) * D;
  const bf16* gb = dout + ((int64_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((int64_t)b * Sk * Hkv + kh) * D;
  const bf16* vb = v + ((int64_t)b * Sk * Hkv + kh) * D;

  for (int e = tid; e < BQ * CH; e += kNT) {
    const int r = e / CH, c = e % CH, qi = q0 + r;
    const bool ok = qi < Sq;
    repro::cp_async16(qs + r * LD + c * 8, ok ? qb + qi * q_stride + c * 8 : q, ok);
    repro::cp_async16(gs + r * LD + c * 8, ok ? gb + qi * q_stride + c * 8 : dout, ok);
  }

  // Keys any real row of this tile can see, in whole BK-key tiles.
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int k_first = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  auto load_kv = [&](int it) {  // tile it, or an empty group past the end
    if (it < n_tiles) {
      const int kt0 = k_first + it * BK;
      bf16* kd = ks + (it % 2) * BK * LD;
      bf16* vd = vs + (it % 2) * BK * LD;
      for (int e = tid; e < BK * CH; e += kNT) {
        const int j = e / CH, c = e % CH, kj = kt0 + j;
        const bool ok = kj < Sk;
        repro::cp_async16(kd + j * LD + c * 8, ok ? kb + kj * kv_stride + c * 8 : k, ok);
        repro::cp_async16(vd + j * LD + c * 8, ok ? vb + kj * kv_stride + c * 8 : v, ok);
      }
    }
    repro::cp_async_commit();
  };
  load_kv(0);  // with Q and dO in the first group

  float dqa[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const int row_g = q0 + warp * 16 + g;  // query row of c[0..1]; c[2..3] are row_g + 8
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows < Sq_pad: the scratch is padded to whole tiles
    const int64_t srow = ((int64_t)b * H + h) * Sq_pad + row_g + 8 * r;
    l2[r] = lse2[srow];
    dl[r] = delta[srow];
  }
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* gw = gs + warp * 16 * LD;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt0 = k_first + it * BK, stage = it % 2;
    load_kv(it + 1);
    repro::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + stage * BK * LD;
    const bf16* vt = vs + stage * BK * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ag[4];
      repro::ldmatrix_x4(aq, qw + (lane % 16) * LD + kk + (lane / 16) * 8);
      repro::ldmatrix_x4(ag, gw + (lane % 16) * LD + kk + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int r = np * 16 + lane % 8 + (lane / 16) * 8, c = kk + ((lane / 8) % 2) * 8;
        uint32_t bk[4], bv[4];
        repro::ldmatrix_x4(bk, kt + r * LD + c);
        repro::ldmatrix_x4(bv, vt + r * LD + c);
        repro::mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        repro::mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        repro::mma_bf16(dp[2 * np], ag, bv[0], bv[1]);
        repro::mma_bf16(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
    const bool edge = kt0 + BK > Sk || (causal && kt0 + BK - 1 > q0 + q_offset) ||
                      (window > 0 && q0 + BQ - 1 + q_offset - kt0 >= window);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >= 2 ? 1 : 0;
        float fac;
        const float x = log2_score(s[n][e], qk_scale, softcap, fac);
        float p = exp2f(x - l2[r]);
        if (edge && !visible(row_g + 8 * r + q_offset, kt0 + n * 8 + 2 * t4 + (e & 1), Sk,
                             causal, window))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - dl[r]) * fac;
      }
    }
    // dQ += dS K, dS as hi + lo (two bf16 products) from the registers
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float* src = dp[2 * j + f / 2] + 2 * (f % 2);
        split_bf16(src[0], src[1], ah[f], al[f]);
      }
      const int r = j * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        uint32_t bk[4];
        repro::ldmatrix_x4_trans(bk, kt + r * LD + dd * 16 + (lane / 16) * 8);
        repro::mma_bf16(dqa[2 * dd], ah, bk[0], bk[1]);
        repro::mma_bf16(dqa[2 * dd + 1], ah, bk[2], bk[3]);
        repro::mma_bf16(dqa[2 * dd], al, bk[0], bk[1]);
        repro::mma_bf16(dqa[2 * dd + 1], al, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  repro::cp_async_wait<0>();
  __syncthreads();  // Q's copy is complete before a warp writes dQ over its rows

  store_rows<NO, LD>(dqa, scale, qs + warp * 16 * LD, dq + ((int64_t)b * Sq * H + h) * D,
                     q_stride, q0 + warp * 16, Sq, lane);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *out, *dout;
  const float* lse;
  float *delta, *lse2;
  bf16 *dq, *dk, *dv;
  int B, Sq, Sk, Sq_pad, H, Hkv, causal, window;
  float softcap, scale;
};

template <int D>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  using KV = DkDvTiles<D>;
  using QT = DqTiles<D>;
  cudaError_t err = repro::allow_smem<flash_bwd_dkdv_bf16<D>>((int)KV::smem());
  if (err != cudaSuccess) return (int)err;
  err = repro::allow_smem<flash_bwd_dq_bf16<D>>((int)QT::smem());
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)a.B * a.H * a.Sq_pad;
  if (rows > 0) {
    const int64_t blocks = (rows + kPrepRows - 1) / kPrepRows;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    flash_bwd_prep_bf16<D><<<(unsigned)blocks, kPrepRows * 32, 0, stream>>>(
        a.out, a.dout, a.lse, a.delta, a.lse2, a.Sq, a.Sq_pad, a.H, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int k_tiles = (a.Sk + KV::BK - 1) / KV::BK * (D / KV::DC);
  if (k_tiles > 0) {
    if (k_tiles > 65535) return (int)cudaErrorInvalidValue;
    flash_bwd_dkdv_bf16<D><<<dim3(a.Hkv, a.B, k_tiles), kNT, KV::smem(), stream>>>(
        a.q, a.k, a.v, a.dout, a.delta, a.lse2, a.dk, a.dv, a.Sq, a.Sk, a.Sq_pad, a.H, a.Hkv,
        a.causal, a.window, a.softcap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int q_tiles = (a.Sq + QT::BQ - 1) / QT::BQ;
  if (q_tiles > 0) {
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
    flash_bwd_dq_bf16<D><<<dim3(a.H, a.B, q_tiles), kNT, QT::smem(), stream>>>(
        a.q, a.k, a.v, a.dout, a.delta, a.lse2, a.dq, a.Sq, a.Sk, a.Sq_pad, a.H, a.Hkv,
        a.causal, a.window, a.softcap, a.scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq (B, Sq, H, D) and k, v, dk, dv (B, Sk, Hkv, D) bf16; lse
// (B, Sq, H) f32 from the forward; delta and lse2 (B, H, Sq_pad) f32 scratch,
// Sq_pad = Sq rounded up to 64. window <= 0 means no window, softcap <= 0 no
// cap. bf16 only: the f32 backward is the plain version.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const float* lse,
                                         float* delta, float* lse2, void* dq, void* dk, void* dv,
                                         int B, int Sq, int Sk, int H, int Hkv, int D, int causal,
                                         int window, float softcap, float scale, int dtype,
                                         void* stream) {
  if (dtype != repro::kBF16 || Hkv < 1 || H % Hkv != 0 || H > 65535 || B > 65535 || B < 0 ||
      Sq < 0 || Sk < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {q, k, v, out, dout, delta, lse2, dq, dk, dv};
  for (const void* p : ptrs) {
    if (!repro::aligned16(p)) return (int)cudaErrorMisalignedAddress;  // 16-byte copies
  }
  const BwdArgs a{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),   static_cast<const bf16*>(out),
                  static_cast<const bf16*>(dout), lse, delta, lse2,
                  static_cast<bf16*>(dq),        static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv),        B, Sq, Sk, (Sq + kRowPad - 1) / kRowPad * kRowPad,
                  H, Hkv, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bwd<32>(a, s);
    case 64: return launch_bwd<64>(a, s);
    case 80: return launch_bwd<80>(a, s);
    case 128: return launch_bwd<128>(a, s);
    case 256: return launch_bwd<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
