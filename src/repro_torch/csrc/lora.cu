// NanoAdapter (LoRA) residual kernels for Hopper (sm_90a):
//   y = x + scale * (x A) B, math in fp32, one cast to x's dtype at the end.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/lora/lora.py::lora_residual_2d          (_kernel, line 29)
//   src/repro/kernels/lora/lora.py::grouped_lora_residual_2d  (_grouped_kernel, line 78)
// and what jax.vmap makes of the first over a cohort of K clients, each with its
// own adapter (the vmap round engine's batched pallas_call): repro_lora_residual_many.
//
// What bounds it on an H100: the work is 4*T*D*r fp32 operations over
// 2*T*D*sizeof(x) + 2*D*r*4 bytes. At the prefill shape (T = 128, D = 4096,
// r = 64, bf16 x) that is 134 MFLOP against 4.2 MB: 2.0 us at the 67 TFLOP/s
// fp32 rate of the CUDA cores, 1.25 us at 3.35 TB/s, so the fp32 operations
// bound the CUDA-core design, narrowly. The tensor-core design below does
// 2.5x those operations (five TF32 products) at 495 TFLOP/s: 0.68 us, so
// bytes bound it. At the decode shape (8 rows, grouped) the adapter bytes
// bound it: 4 adapters in use are 8.4 MB, 2.5 us at 3.35 TB/s, against 8.4
// MFLOP, 0.13 us on the CUDA cores; bytes stay the bound up to about 40 rows
// an adapter. chip_smoke.py computes the bounds for every shape it times.
//
// Two designs, chosen by dtype at the C entry point (no fallback between
// them).
//
// * The grouped kernel in both dtypes, and f32 x with one adapter (namespace
//   cc, fp32 FMAs on the CUDA cores: tensor-core products cannot hold the f32
//   path's 1e-6). Two launches per 256 rows, built around the adapters in use:
//   - Work units. Each block reads idx (at most kPlanRows ids a launch; the
//     entry point walks longer inputs in pieces) and derives, with warp 0,
//     the adapters in use in order of first appearance and their rows in
//     tiles of kRows; blockIdx.y picks the (adapter, row tile) unit. Up to
//     32 ids (a decode step) take one id a lane and __match_any_sync, with
//     no shared memory and one barrier. Blocks past the last unit exit at
//     once, so a call streams the adapters in use, not the N slots of the
//     bank, and the rows of one adapter are gathered by index, never sorted
//     in memory. The host never reads idx, so the call stays capturable in a
//     CUDA graph. A single adapter is the same kernels with no idx: unit w
//     is rows [w*kRows, (w+1)*kRows). One more row of pass-1 blocks copies
//     the rows whose id lies outside [0, N) through as x, bit for bit.
//   - Pass 1 (down), grid (kSplit d-chunks x rank groups of kRJ columns,
//     units): the unit's x rows and its A slice stream through a ring of
//     kStages cp.async stages of kSubD d (16-byte copies when shapes and
//     alignment allow, else 4-byte copies or element loads), 16 KB of A in
//     flight a block, into partial h per d-chunk in the scratch. At 4
//     adapters in use that is 256 blocks, all of A in flight at once, spread
//     over every SM: an SM takes in only a few tens of GB/s.
//   - Pass 2 (up), grid (kCols-column slices, units), a programmatic
//     dependent launch: its blocks start once every pass-1 block has, copy
//     their B slice (16 KB at r 64) and x tile with cp.async, and only then
//     wait for pass 1 (griddepcontrol.wait), so B, half the bytes, is read
//     beside A rather than after it. Then h = the d-chunks' partials summed
//     in chunk order, and y = x + scale * h B for kCols columns.
//   - Instructions, not FMAs or bytes, set the pace of both passes' loops:
//     the SM's schedulers issue every instruction of a predicated-off row.
//     So pass 1's loop is instantiated for the unit's row count (a decode
//     step's units hold one or two), and pass 2 takes one row a thread when
//     a unit has at most kThreads / kCols rows. Both kernels stay at 32
//     registers: 8 blocks an SM let all pass-1 blocks start at once, which
//     is when pass 2 may launch.
//   - Tried and not kept (PERF.md): one launch with a 16-block cluster per
//     adapter (TMA bulk copies, partials summed over distributed shared
//     memory) put 128 KB on each of 64 SMs and was slower; so were TMA
//     tensor-map boxes for A and B, 32 contiguous d-chunks, partials summed
//     per cluster in pass 1, 8 d-chunks, and a later dependent trigger.
//   - Sum order, fixed by (D, r) alone: D is cut into kSplit chunks of
//     round_up(ceil(D / kSplit), 8); within a chunk, G = kThreads / min(r,
//     kRJ) groups each sum every G-th d in order, and the G group sums are
//     added in group order; the chunks' sums in chunk order; then h B in
//     rank order.
//     Explicit __fmaf_rn / __fadd_rn / __fmul_rn, no contraction left to the
//     compiler, no atomics. A row's fp32 operations depend only on that row,
//     A and B, so a row of a mixed-tenant batch equals the single-adapter
//     kernel's row bit for bit in fp32, the property lora.py:72-74 pins for
//     the TPU kernel.
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
// * K clients at once (repro_lora_residual_many, the cohort engine's call): the
//   same kernels and launches as one adapter, with the client in the grid:
//   blockIdx.z in namespace cc (f32), folded into the row tiles of blockIdx.x
//   in namespace tc (bf16). A block offsets x, out, its client's A and B and
//   the scratch by its client's rows, so a client's rows meet only its own
//   adapter and a pass is one launch over all K clients, not K launches. The
//   bytes to move are K times one adapter's: at the cohort's text rows (K = 4,
//   T = 128, D = 4096, r = 64, bf16 x) 12.6 MB, 3.8 us at 3.35 TB/s. PERF.md
//   times it beside K launches of the one-adapter kernel.

#include <algorithm>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kSplit = 16;      // d-chunks of the down-projection; lora/ops.py::SPLIT
constexpr int kMaxRank = 256;   // lora/ops.py::MAX_RANK

// M[r0 .. r0 + nr, c0 .. c0 + nc) of an f32 matrix with row stride ldm ->
// ms (row stride ld), zero outside [0, r_end) x [0, c_end). 16-byte copies
// when vec (c_end % 4 == 0, c0 % 4 == 0 and aligned), else 4-byte copies.
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

// ---------------------------------------------------------------------------
// The grouped kernel, and f32 x with one adapter: CUDA cores (see the note
// at the top)
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kRows = 8;         // rows of a work unit
constexpr int kPlanRows = 256;   // rows (ids) a launch plans over
constexpr int kRJ = 16;          // rank columns of a pass-1 block
constexpr int kSubD = 64;        // d of x and A per pass-1 stage
constexpr int kStages = 4;       // pass-1 stages in flight: 16 KB of A
constexpr int kCols = 64;        // output columns of a pass-2 block

// One block's work unit: the rows (launch-local indices) of one adapter's
// row tile, n of them; adapter < 0 when the block has none.
struct Unit {
  int adapter, n;
  int rows[kRows];
};

// Fill u with work unit w of this launch's T rows. With idx, the units are
// the adapters in use, in order of first appearance, each cut into tiles of
// kRows of its rows in row order; ids outside [0, N) take no unit. Without
// idx, one adapter (0) and unit w is rows [w*kRows, (w+1)*kRows). All
// threads call; the answer is block-uniform.
__device__ bool plan_unit(const int* __restrict__ idx, int T, int N, int w, int* idx_s,
                          Unit& u) {
  const int t0 = threadIdx.x;
  if (idx == nullptr) {
    if (t0 == 0) {
      u.adapter = w * kRows < T ? 0 : -1;
      u.n = min(kRows, T - w * kRows);
    }
    if (t0 < kRows) u.rows[t0] = w * kRows + t0;
    __syncthreads();
    return u.adapter >= 0;
  }
  constexpr unsigned kAll = 0xffffffffu;
  if (T <= 32) {  // a decode step: one id a lane, no shared memory, one barrier
    if (t0 < 32) {
      const int lane = t0, raw = lane < T ? idx[lane] : -1;
      const int v = raw >= 0 && raw < N ? raw : -1;
      const unsigned same = __match_any_sync(kAll, v);  // the lanes holding this id
      const bool first = v >= 0 && __ffs(same) - 1 == lane;
      const int tiles = first ? (__popc(same) + kRows - 1) / kRows : 0;
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += y;
      }
      const int base = incl - tiles;
      const unsigned hit = __ballot_sync(kAll, tiles > 0 && w >= base && w < base + tiles);
      const int src = hit ? __ffs(hit) - 1 : 0;
      const int found = hit ? __shfl_sync(kAll, v, src) : -1;
      const int tile = w - __shfl_sync(kAll, base, src);
      const bool mine = found >= 0 && v == found;
      const unsigned m = __ballot_sync(kAll, mine);
      const int pos = __popc(m & ((1u << lane) - 1));
      if (mine && pos / kRows == tile) u.rows[pos % kRows] = lane;
      if (lane == 0) {
        u.adapter = found;
        u.n = found >= 0 ? min(kRows, __popc(m) - tile * kRows) : 0;
      }
    }
    __syncthreads();
    return u.adapter >= 0;
  }
  for (int t = t0; t < T; t += blockDim.x) {  // longer: the ids in shared memory, warp 0 plans
    const int v = idx[t];
    idx_s[t] = v >= 0 && v < N ? v : -1;
  }
  __syncthreads();
  if (t0 < 32) {
    const int lane = t0;
    int carry = 0, found = -1, tile = 0;  // warp-uniform
    for (int c0 = 0; c0 < T && found < 0; c0 += 32) {
      const int t = c0 + lane;
      const int v = t < T ? idx_s[t] : -1;
      bool first = v >= 0;
      int cnt = 0;
      if (v >= 0) {
        for (int s = 0; s < T; ++s) {
          if (idx_s[s] == v) {
            first = first && s >= t;
            ++cnt;
          }
        }
      }
      const int tiles = first ? (cnt + kRows - 1) / kRows : 0;
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += y;
      }
      const int base = carry + incl - tiles;
      const unsigned hit = __ballot_sync(kAll, tiles > 0 && w >= base && w < base + tiles);
      if (hit) {
        const int src = __ffs(hit) - 1;
        found = __shfl_sync(kAll, v, src);
        tile = w - __shfl_sync(kAll, base, src);
      }
      carry += __shfl_sync(kAll, incl, 31);
    }
    int seen = 0;
    if (found >= 0) {
      for (int c0 = 0; c0 < T; c0 += 32) {
        const int t = c0 + lane;
        const bool mine = t < T && idx_s[t] == found;
        const unsigned m = __ballot_sync(kAll, mine);
        const int pos = seen + __popc(m & ((1u << lane) - 1));
        if (mine && pos / kRows == tile) u.rows[pos % kRows] = t;
        seen += __popc(m);
      }
    }
    if (lane == 0) {
      u.adapter = found;
      u.n = found >= 0 ? min(kRows, seen - tile * kRows) : 0;
    }
  }
  __syncthreads();
  return u.adapter >= 0;
}

// x[rows[i], c0 .. c0 + nc) for i < n -> xs (row stride ld), zero outside
// [c0, c_end) and for i >= n. 16-byte cp.async when vec (the row width and
// c0 multiples of 16 bytes and x aligned, so a chunk is wholly in or out),
// else element loads.
template <typename T>
__device__ __forceinline__ void stage_rows(T* xs, int ld, const T* __restrict__ x,
                                           const Unit& u, int D, int c0, int nc, int c_end,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int ch = nc / E;
    for (int e = threadIdx.x; e < kRows * ch; e += blockDim.x) {
      const int i = e / ch, c = (e % ch) * E, col = c0 + c;
      const bool ok = i < u.n && col < c_end;
      repro::cp_async16(xs + i * ld + c, ok ? x + (int64_t)u.rows[i] * D + col : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * nc; e += blockDim.x) {
      const int i = e / nc, c = e % nc, col = c0 + c;
      xs[i * ld + c] = i < u.n && col < c_end ? x[(int64_t)u.rows[i] * D + col] : from_f32<T>(0.f);
    }
  }
}

// Pass 1's inner loop for a unit of NR rows: acc[i] += x[row i, p] A[p, j]
// over the stage's chunk offsets p = p_first, p_first + G, ... < p1, in order
// (at: the stage's A tile [kSubD][kRJ]; xt: its x tile [kRows][kSubD]).
template <typename T, int NR>
__device__ __forceinline__ void fma_rows(const float* at, const T* xt, int j, int p_first, int p0,
                                         int p1, int G, float (&acc)[kRows]) {
  for (int p = p_first; p < p1; p += G) {
    const float a = at[(p - p0) * kRJ + j];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = __fmaf_rn(to_f32(xt[i * kSubD + p - p0]), a, acc[i]);
  }
}

// Rows whose id lies outside [0, N): out = x, columns [c0, c1).
template <typename T>
__device__ void copy_identity_rows(const T* __restrict__ x, const int* __restrict__ idx,
                                   T* __restrict__ out, int T_rows, int D, int N, int c0,
                                   int c1) {
  const int w = c1 - c0;
  for (int e = threadIdx.x; e < T_rows * w; e += blockDim.x) {
    const int t = e / w, v = idx[t];
    if (v < 0 || v >= N) {
      const int64_t o = (int64_t)t * D + c0 + e % w;
      out[o] = x[o];
    }
  }
}

// Pass 1, grid (chunks * rank groups, units [+ 1 identity row]): partial[row][s][j]
// = x[row, chunk s] . A[chunk s, j] for the unit's rows and this block's kRJ
// columns j, in the order of the note at the top.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    down_kernel(const T* __restrict__ x, const float* __restrict__ A, const int* __restrict__ idx,
                float* __restrict__ partial, T* __restrict__ out, int T_rows, int D, int r, int N,
                int chunk, int groups, bool vec_x, bool vec_a) {
  repro::griddep_launch_dependents();  // pass 2 may start and prefetch B now
  __shared__ int idx_s[kPlanRows];
  __shared__ Unit u;
  __shared__ __align__(16) float as[kStages][kSubD][kRJ];  // then the group sums
  __shared__ __align__(16) unsigned char xs_raw[sizeof(T) * kStages * kRows * kSubD];
  T* xs = reinterpret_cast<T*>(xs_raw);  // [kStages][kRows][kSubD]

  // a batched call's client (blockIdx.z, 0 in the other calls): its rows,
  // its adapter and its scratch
  const int64_t kc = blockIdx.z;
  x += kc * T_rows * D;
  out += kc * T_rows * D;
  A += kc * D * r;
  partial += kc * T_rows * kSplit * r;
  const int s = blockIdx.x / groups, j0 = (blockIdx.x % groups) * kRJ;
  if (idx != nullptr && blockIdx.y == gridDim.y - 1) {  // the identity rows
    const int w = (D + gridDim.x - 1) / gridDim.x, c0 = blockIdx.x * w;
    copy_identity_rows<T>(x, idx, out, T_rows, D, N, c0, min(D, c0 + w));
    return;
  }
  if (!plan_unit(idx, T_rows, N, blockIdx.y, idx_s, u)) return;
  const float* Aa = A + (int64_t)u.adapter * D * r;
  const int d0 = s * chunk, len = min(D, d0 + chunk) - d0;
  const int n_sub = (len + kSubD - 1) / kSubD;
  const int rj = min(r, kRJ), G = kThreads / rj;
  const int t = threadIdx.x, j = t % rj, g = t / rj;
  const bool active = g < G;

  auto stage = [&](int it) {  // an empty commit group past the end keeps the count
    if (it < n_sub) {
      const int buf = it % kStages, dd = d0 + it * kSubD;
      stage_f32(&as[buf][0][0], kRJ, Aa, r, dd, kSubD, d0 + len, j0, kRJ, r, vec_a);
      stage_rows<T>(xs + buf * kRows * kSubD, kSubD, x, u, D, dd, kSubD, d0 + len, vec_x);
    }
    repro::cp_async_commit();
  };
  const int n = u.n;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) stage(it);
  for (int it = 0; it < n_sub; ++it) {
    stage(it + kStages - 1);
    repro::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int buf = it % kStages, p0 = it * kSubD, p1 = min(len, p0 + kSubD);
    const T* xt = xs + buf * kRows * kSubD;  // [kRows][kSubD]
    if (active) {
      // this group's d (chunk offsets p = g, g + G, ...) that lie in the stage, in order
      const int p_first = p0 + ((g - p0 % G) + G) % G;
      switch (n) {  // only the unit's rows: a decode step's units hold one or two
        case 1: fma_rows<T, 1>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 2: fma_rows<T, 2>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 3: fma_rows<T, 3>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 4: fma_rows<T, 4>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 5: fma_rows<T, 5>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 6: fma_rows<T, 6>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        case 7: fma_rows<T, 7>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
        default: fma_rows<T, kRows>(&as[buf][0][0], xt, j, p_first, p0, p1, G, acc); break;
      }
    }
    __syncthreads();  // readers of this stage are done before it is refilled
  }
  float* red = &as[0][0][0];  // [kRows][kThreads]: the ring is drained
  if (active) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) red[i * kThreads + g * rj + j] = acc[i];
  }
  __syncthreads();
  for (int e = t; e < n * rj; e += kThreads) {
    const int i = e / rj, jj = e % rj;
    if (j0 + jj < r) {
      float sum = 0.f;
      for (int gg = 0; gg < G; ++gg) sum = __fadd_rn(sum, red[i * kThreads + gg * rj + jj]);
      partial[((int64_t)u.rows[i] * kSplit + s) * r + j0 + jj] = sum;
    }
  }
}

template <typename T>
constexpr size_t up_smem(int r) {  // B slice, h, x tile
  return sizeof(float) * ((size_t)r * kCols + (size_t)kRows * r) + sizeof(T) * kRows * kCols;
}

// Pass 2, grid (column slices, units), a programmatic dependent of pass 1:
// out[row, c] = x[row, c] + scale * (h . B)[c] with h the d-chunks' partials
// summed in chunk order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    up_kernel(const T* __restrict__ x, const float* __restrict__ B, const int* __restrict__ idx,
              const float* __restrict__ partial, T* __restrict__ out, int T_rows, int D, int r,
              int N, int n_chunks, float scale, bool vec_x, bool vec_b) {
  __shared__ int idx_s[kPlanRows];
  __shared__ Unit u;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bs = reinterpret_cast<float*>(smem_raw);        // [r][kCols]
  float* hs = bs + r * kCols;                            // [kRows][r]
  T* xs = reinterpret_cast<T*>(hs + kRows * r);          // [kRows][kCols]

  const int64_t kc = blockIdx.z;  // a batched call's client, as in down_kernel
  x += kc * T_rows * D;
  out += kc * T_rows * D;
  B += kc * r * D;
  partial += kc * T_rows * kSplit * r;
  if (!plan_unit(idx, T_rows, N, blockIdx.y, idx_s, u)) return;
  const int c0 = blockIdx.x * kCols;
  // B and x do not depend on pass 1: copy them while it runs
  stage_f32(bs, kCols, B + (int64_t)u.adapter * r * D, D, 0, r, r, c0, kCols, D, vec_b);
  stage_rows<T>(xs, kCols, x, u, D, c0, kCols, D, vec_x);
  repro::cp_async_commit();
  repro::griddep_wait();  // pass 1 has finished and its partials are visible

  const int n = u.n;
  for (int e = threadIdx.x; e < n * r; e += kThreads) {
    const int i = e / r, j = e % r;
    const float* p = partial + (int64_t)u.rows[i] * kSplit * r + j;
    float v[kSplit];
#pragma unroll
    for (int s = 0; s < kSplit; ++s) v[s] = s < n_chunks ? p[s * r] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      if (s < n_chunks) sum = __fadd_rn(sum, v[s]);
    }
    hs[i * r + j] = sum;
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  constexpr int kGroups = kThreads / kCols, kPer = kRows / kGroups;
  const int c = threadIdx.x % kCols, ig = threadIdx.x / kCols;
  if (c0 + c >= D || ig >= n) return;
  if (n <= kGroups) {  // one row a thread (a decode step's units hold one or two)
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < r; ++j) acc = __fmaf_rn(hs[ig * r + j], bs[j * kCols + c], acc);
    const int64_t o = (int64_t)u.rows[ig] * D + c0 + c;
    out[o] = from_f32<T>(__fadd_rn(to_f32(xs[ig * kCols + c]), __fmul_rn(scale, acc)));
    return;
  }
  float acc[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int j = 0; j < r; ++j) {
    const float b = bs[j * kCols + c];
#pragma unroll
    for (int m = 0; m < kPer; ++m) acc[m] = __fmaf_rn(hs[(ig + m * kGroups) * r + j], b, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = ig + m * kGroups;
    if (i < n) {
      const int64_t o = (int64_t)u.rows[i] * D + c0 + c;
      out[o] = from_f32<T>(__fadd_rn(to_f32(xs[i * kCols + c]), __fmul_rn(scale, acc[m])));
    }
  }
}

// Both passes over t rows (of each of K clients: grid z), one launch each.
// idx == nullptr: one adapter a client (N = 1).
template <typename T>
cudaError_t launch_pass(const T* x, const float* A, const float* B, const int* idx,
                        float* partial, T* out, int t, int D, int r, int N, int K, float scale,
                        cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int chunk = ((D + kSplit - 1) / kSplit + 7) / 8 * 8;
  const int n_chunks = (D + chunk - 1) / chunk;
  const int groups = (r + kRJ - 1) / kRJ;
  const bool vec_a = r % 4 == 0 && repro::aligned16(A);
  const bool vec_b = D % 4 == 0 && repro::aligned16(B);
  const bool vec_x = D % E == 0 && repro::aligned16(x);
  // units: at most min(adapters, rows) tiles' first rows plus the rest in
  // whole tiles
  const int units = idx == nullptr ? (t + kRows - 1) / kRows
                                   : std::min(t, std::min(N, t) + (t - 1) / kRows);
  const dim3 g1(n_chunks * groups, units + (idx != nullptr ? 1 : 0), K);
  down_kernel<T><<<g1, kThreads, 0, stream>>>(x, A, idx, partial, out, t, D, r, N, chunk, groups,
                                              vec_x, vec_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kCols - 1) / kCols, units, K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = up_smem<T>(r);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, up_kernel<T>, x, B, idx, (const float*)partial, out, t, D, r,
                            N, n_chunks, scale, vec_x, vec_b);
}

// Rows [0, T) in pieces of kPlanRows. idx == nullptr: one adapter (N = 1).
template <typename T>
cudaError_t launch(const T* x, const float* A, const float* B, const int* idx, float* scratch,
                   T* out, int T_rows, int D, int r, int N, float scale, cudaStream_t stream) {
  cudaError_t err = repro::allow_smem<up_kernel<T>>((int)up_smem<T>(kMaxRank));
  if (err != cudaSuccess) return err;
  for (int off = 0; off < T_rows; off += kPlanRows) {
    const int t = std::min(kPlanRows, T_rows - off);
    err = launch_pass<T>(x + (int64_t)off * D, A, B, idx == nullptr ? nullptr : idx + off,
                         scratch + (int64_t)off * kSplit * r, out + (int64_t)off * D, t, D, r, N,
                         1, scale, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// K clients of T_rows rows each, client k's rows through adapter k: one
// launch a pass (units need no plan without idx, so no pieces).
template <typename T>
cudaError_t launch_many(const T* x, const float* A, const float* B, float* scratch, T* out,
                        int K, int T_rows, int D, int r, float scale, cudaStream_t stream) {
  cudaError_t err = repro::allow_smem<up_kernel<T>>((int)up_smem<T>(kMaxRank));
  if (err == cudaSuccess) {
    err = launch_pass<T>(x, A, B, nullptr, scratch, out, T_rows, D, r, 1, K, scale, stream);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace cc

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

  // blockIdx.x: a batched call's client (0 in the other calls) and its row tile
  const int tiles = (T + kRows - 1) / kRows;
  const int64_t kc = blockIdx.x / tiles;
  x += kc * T * D;
  A += kc * D * r;
  partial += kc * T * kSplit * r;
  const int row0 = (blockIdx.x % tiles) * kRows, s = blockIdx.y, j0 = blockIdx.z * kNB;
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

  const int tiles = (T + kRows - 1) / kRows;  // the client and row tile, as in down_kernel
  const int64_t kc = blockIdx.x / tiles;
  x += kc * T * D;
  B += kc * r * D;
  h_in += kc * T * kSplit * r;
  out += kc * T * D;
  const int row0 = (blockIdx.x % tiles) * kRows, c0 = blockIdx.y * COLS;
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

// K clients of T rows each (K = 1: one adapter), client k's rows through
// adapter k.
template <int RP>
int launch(const bf16* x, const float* A, const float* B, float* scratch, bf16* out, int K,
           int T, int D, int r, float scale, cudaStream_t stream) {
  cudaError_t err = repro::allow_smem<down_kernel>((int)kDownSmem);
  if (err == cudaSuccess) err = repro::allow_smem<up_kernel<RP>>((int)up_smem<RP>());
  // About four pass-1 blocks per SM: split D into up to kSplit chunks,
  // each a whole number of kSubD stages.
  int sms = 0;
  if (err == cudaSuccess) err = repro::device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = K * ((T + kRows - 1) / kRows), groups = (r + kNB - 1) / kNB;
  const int want = std::max(1, std::min(kSplit, (4 * sms + tiles * groups - 1) / (tiles * groups)));
  const int chunk = ((D + want - 1) / want + kSubD - 1) / kSubD * kSubD;
  const int splits = (D + chunk - 1) / chunk;
  const bool vec_x = D % 8 == 0 && repro::aligned16(x) && repro::aligned16(out);
  const bool vec_a = r % 4 == 0 && repro::aligned16(A);
  const bool vec_b = D % 4 == 0 && repro::aligned16(B);
  const bool vec_h = r % 4 == 0 && repro::aligned16(scratch);
  down_kernel<<<dim3(tiles, splits, groups), kDownThreads, kDownSmem, stream>>>(
      x, A, scratch, T, D, r, chunk, vec_x, vec_a);
  if (splits > 1) {  // the scratch rows of all K clients are contiguous: one launch
    const int64_t n = (int64_t)K * T * r;
    sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(scratch, K * T, r,
                                                                       splits);
  }
  up_kernel<RP><<<dim3(tiles, (D + kCols - 1) / kCols), kThreads, up_smem<RP>(), stream>>>(
      x, B, scratch, out, T, D, r, scale, vec_x, vec_b, vec_h);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const float* A, const float* B, float* scratch, void* out, int K,
             int T, int D, int r, float scale, cudaStream_t stream) {
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (r <= 16) return launch<16>(xb, A, B, scratch, ob, K, T, D, r, scale, stream);
  if (r <= 32) return launch<32>(xb, A, B, scratch, ob, K, T, D, r, scale, stream);
  if (r <= 64) return launch<64>(xb, A, B, scratch, ob, K, T, D, r, scale, stream);
  if (r <= 128) return launch<128>(xb, A, B, scratch, ob, K, T, D, r, scale, stream);
  return launch<256>(xb, A, B, scratch, ob, K, T, D, r, scale, stream);
}

}  // namespace tc

bool bad_shape(int64_t n_rows, int D, int r, int64_t scratch_floats) {
  return r < 1 || r > kMaxRank || D < 1 || n_rows < 0 || n_rows * kSplit * r > scratch_floats;
}

}  // namespace

// scratch: fp32, at least n_rows * kSplit * r floats: the partial h of
// either design.
extern "C" int repro_lora_residual(const void* x, const float* A, const float* B, float* scratch,
                                   long long scratch_floats, void* out, int n_rows, int D, int r,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    return (int)cc::launch<float>(static_cast<const float*>(x), A, B, nullptr, scratch,
                                  static_cast<float*>(out), n_rows, D, r, 1, scale, s);
  }
  if (dtype == repro::kBF16) return tc::dispatch(x, A, B, scratch, out, 1, n_rows, D, r, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K clients of n_rows rows each, contiguous in x and out; A (K, D, r) and B
// (K, r, D) client-major; scratch at least K * n_rows * kSplit * r floats.
extern "C" int repro_lora_residual_many(const void* x, const float* A, const float* B,
                                        float* scratch, long long scratch_floats, void* out,
                                        int K, int n_rows, int D, int r, float scale, int dtype,
                                        void* stream) {
  if (K < 1 || K > 65535 || bad_shape((int64_t)K * n_rows, D, r, scratch_floats)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    if ((n_rows + cc::kRows - 1) / cc::kRows > 65535) return (int)cudaErrorInvalidValue;
    return (int)cc::launch_many<float>(static_cast<const float*>(x), A, B, scratch,
                                       static_cast<float*>(out), K, n_rows, D, r, scale, s);
  }
  if (dtype == repro::kBF16) return tc::dispatch(x, A, B, scratch, out, K, n_rows, D, r, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_grouped_lora_residual(const void* x, const float* A, const float* B,
                                           const int* idx, float* scratch,
                                           long long scratch_floats, void* out, int n_rows, int D,
                                           int r, int N, float scale, int dtype, void* stream) {
  if (bad_shape(n_rows, D, r, scratch_floats) || N < 1 || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    return (int)cc::launch<float>(static_cast<const float*>(x), A, B, idx, scratch,
                                  static_cast<float*>(out), n_rows, D, r, N, scale, s);
  }
  if (dtype == repro::kBF16) {
    using bf16 = __nv_bfloat16;
    return (int)cc::launch<bf16>(static_cast<const bf16*>(x), A, B, idx, scratch,
                                 static_cast<bf16*>(out), n_rows, D, r, N, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
