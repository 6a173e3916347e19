// Mamba2 SSD chunked scan for Hopper (sm_90a):
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t . h_t
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_chunked_pallas  (_kernel, line 26;
//   pallas_call, line 81)
//
// Shapes: x (Bt, S, H, P) and dt (Bt, S, H) in f32 or bf16, A (H,) f32,
// B and C (Bt, S, N); y like x. Q = min(chunk, S); the ragged last chunk is
// read as zeros (dt = 0 there: decay 1, update 0), so nothing is padded in
// memory. x, B and C may be strided views over time and batch (the model
// passes slices of one projection); their last axes are contiguous.
//
// The TPU kernel walks its grid (b, h, chunk) in order and carries h from
// one chunk to the next in VMEM. Here the chunked algorithm of
// arXiv:2405.21060 §6 (the JAX oracle ref.py::ssd_chunked) runs in three
// launches, parallel over chunks. With L = cumsum(dt A) within each chunk:
//
//   1. chunk_state: per (b, chunk, head, 64 state rows), every chunk but the
//      last (nothing reads its state):
//        S_c = sum_j (w_j B_j) x_j^T,   w_j = dt_j exp(L_last - L_j)
//   2. state_passing: elementwise over (b, head, n, p), a scan over chunks:
//        H_1 = S_0,   H_{c+1} = exp(L_last,c) H_c + S_c
//      (not launched for two chunks or fewer: H_1 = S_0 already)
//   3. chunk_output: per (b, chunk, 64-row query tile, head):
//        y_i = exp(L_i) C_i . H_c  +  sum_{j<=i} [(C_i . B_j) exp(L_i - L_j) dt_j] x_j
//      with C . H skipped on chunk 0 (H = 0 there).
//
// The chunk states go through device memory in f32, N x 64 per (b, chunk,
// head) (9.4 MB at mamba2-130m's training shape), and for bf16 also as
// bf16(H_c), the operand phase 3 reads. The C entry point takes no scratch
// argument, so it takes them from a private stream-ordered pool that keeps
// its memory between calls; a CUDA graph can capture the calls.
//
// L is the same function in phases 1 and 3: each term dt_i A rounded to f32
// as in the plain version, the prefix summed in double by a warp scan and
// rounded once to f32 (the f32 value nearest the exact prefix, in any order).
// Scores above the diagonal are selected to 0 BEFORE any exponential
// (L_i - L_j > 0 there and exp could overflow; inf * 0 would be NaN).
//
// Two instantiations of phases 1 and 3, chosen by dtype at the C entry point:
//
// * bf16 (the main path): tensor cores, mma.sync.m16n8k16 bf16 with f32
//   accumulation fed by ldmatrix from tiles copied with 16-byte cp.async
//   (rows padded by 16 bytes, so ldmatrix hits every bank once), 4 warps a
//   block, 16 rows each, key tiles through a two-stage ring. Phase 3 forms
//   C . B^T of a (64 query, 64 key) tile in registers, scales it by
//   exp(L_i - L_j) dt_j, rounds it to bf16 and feeds it straight to the
//   product with x as the A operand (the accumulator's layout is the A
//   operand's); the query tiles with the most key tiles go first. Phase 1
//   applies w_j to B's fragments in registers. Rounded to bf16 before a
//   product: w_j B_j, the scaled score tile and H_c; ref.py's
//   ssd_chunked_bf16_model spells that out. Measured on the H100
//   (PERF.md): a block is bound by the latency of its chain of tile loads
//   and barriers, not by its products, so C . B^T is formed for each head:
//   sharing it across 2 or 4 heads of a block (tried) costs registers and
//   shared memory (fewer blocks an SM) and was no faster at training's
//   shape and slower at serving's, where it also leaves SMs idle.
//
// * f32 (the parity tests' 1e-6 path): the same phases with f32 FMAs on the
//   CUDA cores, 16 x 16 threads each owning 4 x 4 outputs of a 64 x 64
//   tile; the model's arithmetic without rounding.
//
// What bounds it on an H100: at mamba2-130m's training shape (4, 1024) the
// function needs 4.2 GFLOP of products and moves 27.5 MB, so in bf16 on the
// tensor cores device memory bounds it (chip_smoke.py computes the bound).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::allow_smem;  // raise a kernel's dynamic shared memory limit, once per device
using repro::to_f32;

constexpr int kMaxN = 128;       // state width
constexpr int kMaxP = 64;        // head width
constexpr int kTile = 64;        // steps a query or key tile; state rows a phase-1 block
constexpr int kLdN = kMaxN + 8;  // bf16 row stride of C and B tiles (16 bytes of padding)
constexpr int kLdP = kMaxP + 8;  // bf16 row stride of x, H and phase-1 B tiles
constexpr int kTcThreads = 128;  // bf16: 4 warps, 16 rows each
constexpr int kThreads = 256;    // f32: 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTile + 1;   // f32 row stride of transposed tiles and the score tile
constexpr int kPassThreads = 256;

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// dts[i] = dt at chunk step i for i < len, 0 at or past S; dt points at
// step 0 of the chunk (row stride H). All threads of the block, one pass of
// independent loads.
template <typename T>
__device__ __forceinline__ void load_dt(float* __restrict__ dts, const T* __restrict__ dt, int H,
                                        int t0, int len, int S) {
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    dts[i] = t0 + i < S ? to_f32(dt[(long long)i * H]) : 0.f;
}

// L[i] = sum_{k<=i} dts[k] A for i < len. Run by one warp.
__device__ void log_decay(float* __restrict__ L, const float* __restrict__ dts, int len, float a) {
  const int lane = threadIdx.x & 31;
  double carry = 0.0;
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    double v = i < len ? (double)__fmul_rn(dts[i], a) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (i < len) L[i] = (float)(carry + v);
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// dst[r][c] (row stride ld) = src[r * st + c] for r < rows, c < cols, and 0
// over the rest of the ROWS x W tile: 16-byte cp.async for whole chunks of
// 16-byte aligned rows (vec), element copies for a ragged chunk, zero stores
// past the edges.
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, int ld,
                                          const bf16* __restrict__ src, long long st, int rows,
                                          int cols, bool vec) {
  constexpr int CH = W / 8;
  for (int e = threadIdx.x; e < ROWS * CH; e += kTcThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* d = dst + r * ld + c;
    if (r >= rows || c >= cols) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec && c + 8 <= cols) {
      repro::cp_async16(d, src + r * st + c, true);
    } else {
      const bf16* s = src + r * st + c;
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = c + k < cols ? s[k] : __float2bfloat16_rn(0.f);
    }
  }
}

// f32: dst[n * kLd + i] = src[i * st + n] for i < rows, n < N; 0 for the
// other rows of the tile.
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const float* __restrict__ src, long long st,
                                                int rows, int N) {
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int i = e / N, n = e - i * N;
    dst[n * kLd + i] = i < rows ? src[i * st + n] : 0.f;
  }
}

// Rows of a tile at chunk step s0 that lie in the chunk and before S.
__device__ __forceinline__ int tile_rows(int s0, int Q, int S, int t0) {
  return max(0, min(min(kTile, Q - s0), S - t0 - s0));
}

// ---------------------------------------------------------------------------
// phase 1: chunk states S_c (Bt, nc - 1, H, N, kMaxP) f32, columns past P
// zero, and decays exp(L_last) (Bt, nc - 1, H); the bf16 kernel also writes
// bf16(S_0) = bf16(H_1) for phase 3. Grid (ceil(N / 64), H, Bt * (nc - 1)).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTcThreads)
    chunk_state_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     float* __restrict__ states, bf16* __restrict__ h_bf,
                     float* __restrict__ decay, int S, int H, int P, int N, int Q, int nc,
                     long long x_sb, long long x_st, long long b_sb, long long b_st, int vec_x,
                     int vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [2][kTile keys][kLdP]: 64 state columns of B
  bf16* xs = bs + 2 * kTile * kLdP;              // [2][kTile keys][kLdP]: x
  float* l_s = reinterpret_cast<float*>(xs + 2 * kTile * kLdP);  // [Q]
  float* w_s = l_s + Q;                          // [Q rounded up to kTile]: dt, then w

  const int n0 = blockIdx.x * kTile, hh = blockIdx.y;
  const int b = blockIdx.z / (nc - 1), c = blockIdx.z % (nc - 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int t0 = c * Q;  // a chunk before the last is whole: t0 + Q <= S
  const int n_tiles = (Q + kTile - 1) / kTile;
  const bf16* xb = x + b * x_sb + t0 * x_st + hh * P;
  const bf16* bb = Bm + b * b_sb + t0 * b_st + n0;

  auto load = [&](int kt) {
    if (kt < n_tiles) {
      const int j0 = kt * kTile, rows = min(kTile, Q - j0);
      load_tile<kTile, kTile>(bs + (kt % 2) * kTile * kLdP, kLdP, bb + j0 * b_st, b_st, rows,
                              N - n0, vec_b);
      load_tile<kTile, kMaxP>(xs + (kt % 2) * kTile * kLdP, kLdP, xb + j0 * x_st, x_st, rows,
                              P, vec_x);
    }
    repro::cp_async_commit();
  };
  load(0);
  load_dt(w_s, dt + ((long long)b * S + t0) * H + hh, H, t0, Q, S);
  __syncthreads();
  if (warp == 0) log_decay(l_s, w_s, Q, A[hh]);
  __syncthreads();
  const float l_last = l_s[Q - 1];
  for (int i = tid; i < n_tiles * kTile; i += kTcThreads)
    w_s[i] = i < Q ? __fmul_rn(w_s[i], expf(l_last - l_s[i])) : 0.f;
  if (blockIdx.x == 0 && tid == 0) decay[blockIdx.z * H + hh] = expf(l_last);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    load(kt + 1);
    repro::cp_async_wait<1>();
    __syncthreads();  // tile kt landed; w_s written
    const bf16* bt = bs + (kt % 2) * kTile * kLdP;
    const bf16* xt = xs + (kt % 2) * kTile * kLdP;
    const float* w = w_s + kt * kTile;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      // A = (w B)^T: 16 state rows x 16 keys, from B's rows by ldmatrix.trans,
      // each key's w applied in registers and rounded to bf16
      uint32_t a[4];
      repro::ldmatrix_x4_trans(a, bt + (kk + lane % 8 + (lane / 16) * 8) * kLdP + warp * 16 +
                                      ((lane / 8) % 2) * 8);
      const float w0 = w[kk + 2 * t4], w1 = w[kk + 2 * t4 + 1];
      const float w2 = w[kk + 8 + 2 * t4], w3 = w[kk + 9 + 2 * t4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[r]);
        a[r] = repro::pack_bf16(__fmul_rn(__low2float(v), r < 2 ? w0 : w2),
                                __fmul_rn(__high2float(v), r < 2 ? w1 : w3));
      }
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, xt + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kLdP +
                                         dp * 16 + (lane / 16) * 8);
        repro::mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        repro::mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled by tile kt + 2
  }
  repro::cp_async_wait<0>();

  // S_c in f32 for phase 2, and S_0 = H_1 in bf16 for phase 3
  const long long off = ((long long)blockIdx.z * H + hh) * N * kMaxP;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + warp * 16 + g + 8 * r;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int e = n * kMaxP + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(states + off + e) =
          make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      if (c == 0)
        *reinterpret_cast<uint32_t*>(h_bf + off + e) =
            repro::pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ decay, int S, int H, int P,
                    int N, int Q, int nc, long long x_sb, long long x_st, long long b_sb,
                    long long b_st) {
  extern __shared__ float smem[];
  float* bs = smem;                 // [kTile keys][kTile state rows]: w B
  float* xs = bs + kTile * kTile;   // [kTile keys][kMaxP]
  float* l_s = xs + kTile * kMaxP;  // [Q]
  float* w_s = l_s + Q;             // [Q]

  const int n0 = blockIdx.x * kTile, hh = blockIdx.y;
  const int b = blockIdx.z / (nc - 1), c = blockIdx.z % (nc - 1);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int t0 = c * Q;
  const float* xb = x + b * x_sb + t0 * x_st + hh * P;
  const float* bb = Bm + b * b_sb + t0 * b_st + n0;

  load_dt(w_s, dt + ((long long)b * S + t0) * H + hh, H, t0, Q, S);
  __syncthreads();
  if (tid < 32) log_decay(l_s, w_s, Q, A[hh]);
  __syncthreads();
  const float l_last = l_s[Q - 1];
  for (int i = tid; i < Q; i += kThreads) w_s[i] = __fmul_rn(w_s[i], expf(l_last - l_s[i]));
  if (blockIdx.x == 0 && tid == 0) decay[blockIdx.z * H + hh] = expf(l_last);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    const int rows = min(kTile, Q - j0);
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int j = e / kTile, n = e % kTile;
      bs[e] = (j < rows && n0 + n < N) ? __fmul_rn(w_s[j0 + j], bb[(j0 + j) * b_st + n]) : 0.f;
    }
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int j = e / kMaxP, p = e % kMaxP;
      xs[e] = (j < rows && p < P) ? xb[(j0 + j) * x_st + p] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float bv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = bs[j * kTile + ty + 16 * a];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[j * kMaxP + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = __fmaf_rn(bv[a], xv[q], acc[a][q]);
    }
    __syncthreads();
  }
  float* out = states + ((long long)blockIdx.z * H + hh) * N * kMaxP;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = n0 + ty + 16 * a;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n < N) out[n * kMaxP + tx + 16 * q] = acc[a][q];
  }
}

// ---------------------------------------------------------------------------
// phase 2: states[b, c] <- H_{c+1} = decay[b, c] H_c + S_c for c = 1 .. nc - 2
// (states[b, 0] = S_0 is H_1 already), and h_bf[b, c] = bf16(H_{c+1}) unless
// h_bf is null (f32). Grid (ceil(N * kMaxP / 256), H, Bt).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
    state_passing(float* __restrict__ states, bf16* __restrict__ h_bf,
                  const float* __restrict__ decay, int H, int NP, int nc) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NP) return;
  const int hh = blockIdx.y, b = blockIdx.z;
  const long long cs = (long long)H * NP;  // chunk stride
  const long long base = ((long long)b * (nc - 1) * H + hh) * NP + e;
  float run = states[base];
  for (int c = 1; c < nc - 1; ++c) {
    run = __fadd_rn(__fmul_rn(decay[(b * (nc - 1) + c) * H + hh], run), states[base + c * cs]);
    states[base + c * cs] = run;
    if (h_bf != nullptr) h_bf[base + c * cs] = __float2bfloat16_rn(run);
  }
}

// ---------------------------------------------------------------------------
// phase 3: outputs. Grid (H, Bt * nc, query tiles), longest first.
// h_bf[b, c - 1] holds bf16(H_c) (bf16), states[b, c - 1] H_c (f32).
// ---------------------------------------------------------------------------

constexpr int kStage = kTile * kLdN + kTile * kLdP;  // bf16 elements: a B tile and an x tile

inline size_t output_smem_bf16(int Q) {
  return sizeof(bf16) * ((size_t)kTile * kLdN + 2 * (size_t)kStage) + sizeof(float) * 2 * (size_t)Q;
}

__global__ void __launch_bounds__(kTcThreads)
    chunk_output_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const bf16* __restrict__ h_bf,
                      bf16* __restrict__ out, int S, int H, int P, int N, int Q, int nc,
                      long long x_sb, long long x_st, long long b_sb, long long b_st,
                      long long c_sb, long long c_st, int vec_x, int vec_b, int vec_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][kLdN]: C of the query tile
  bf16* ring = cs + kTile * kLdN;                // [2][kStage]: B [kTile][kLdN], x [kTile][kLdP]
  bf16* hs = ring + kStage;                      // [kMaxN][kLdP]: bf16(H_c), in stage 1
  float* l_s = reinterpret_cast<float*>(ring + 2 * kStage);  // [Q]
  float* d_s = l_s + Q;                                      // [Q]

  const int hh = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int qi = gridDim.z - 1 - blockIdx.z;  // the tiles with the most key tiles first
  const int i0 = qi * kTile, t0 = c * Q;
  const int t_end = min(Q, i0 + kTile);  // chunk steps whose L this tile needs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nk = (N + 15) / 16;  // k steps over the state

  // group 0: C of the query tile and, after chunk 0, bf16(H_c)
  load_tile<kTile, kMaxN>(cs, kLdN, Cm + b * c_sb + (t0 + i0) * c_st, c_st,
                          tile_rows(i0, Q, S, t0), N, vec_c);
  if (c > 0)
    load_tile<kMaxN, kMaxP>(hs, kLdP,
                            h_bf + ((long long)(b * (nc - 1) + c - 1) * H + hh) * N * kMaxP,
                            kMaxP, N, kMaxP, true);
  repro::cp_async_commit();
  auto load = [&](int kt) {  // key tile kt, or an empty group past the diagonal
    if (kt <= qi) {
      const int j0 = kt * kTile, rows = tile_rows(j0, Q, S, t0);
      bf16* st = ring + (kt % 2) * kStage;
      load_tile<kTile, kMaxN>(st, kLdN, Bm + b * b_sb + (t0 + j0) * b_st, b_st, rows, N, vec_b);
      load_tile<kTile, kMaxP>(st + kTile * kLdN, kLdP, x + b * x_sb + (t0 + j0) * x_st + hh * P,
                              x_st, rows, P, vec_x);
    }
    repro::cp_async_commit();
  };
  load(0);
  load_dt(d_s, dt + ((long long)b * S + t0) * H + hh, H, t0, t_end, S);
  __syncthreads();
  if (warp == 0) log_decay(l_s, d_s, t_end, A[hh]);

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int ri[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ri[r] = i0 + warp * 16 + g + 8 * r;

  // the carried state: o = exp(L_i) C_i . bf16(H_c)
  if (c > 0) {
    repro::cp_async_wait<1>();  // C and H landed (key tile 0 may still be in flight)
    __syncthreads();            // ... for every warp, and L
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, cs + (warp * 16 + lane % 16) * kLdN + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, hs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLdP +
                                         dp * 16 + (lane / 16) * 8);
        repro::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        repro::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float e = ri[r] < t_end ? expf(l_s[ri[r]]) : 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * r] *= e;
        o[n][2 * r + 1] *= e;
      }
    }
    __syncthreads();  // hs (stage 1) is refilled by key tile 1
  }

  // key tiles at or left of the diagonal
  float li[2];
  for (int kt = 0; kt <= qi; ++kt) {
    load(kt + 1);
    repro::cp_async_wait<1>();
    __syncthreads();  // key tile kt, C and L visible to every warp
#pragma unroll
    for (int r = 0; r < 2; ++r) li[r] = ri[r] < t_end ? l_s[ri[r]] : 0.f;
    const bf16* bt = ring + (kt % 2) * kStage;
    const bf16* xt = bt + kTile * kLdN;
    const int j0 = kt * kTile;
    const bool diag = kt == qi;

    // C . B^T: 16 query rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, cs + (warp * 16 + lane % 16) * kLdN + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        repro::ldmatrix_x4(bk, bt + (np * 16 + lane % 8 + (lane / 16) * 8) * kLdN + kk * 16 +
                                   ((lane / 8) % 2) * 8);
        repro::mma_bf16(s[2 * np], a, bk[0], bk[1]);
        repro::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // o += bf16(s exp(L_i - L_j) dt_j) x, 16 keys at a time, the scaled
    // scores going straight from the accumulator to the A operand
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      float v[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * ks + half;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, j = j0 + nt * 8 + 2 * t4 + (e & 1);
          // select before the exponential: above the diagonal L_i - L_j > 0
          const bool keep = ri[r] < t_end && (!diag || j <= ri[r]);
          v[half][e] = keep ? __fmul_rn(__fmul_rn(s[nt][e], expf(li[r] - l_s[j])), d_s[j]) : 0.f;
        }
      }
      const uint32_t a[4] = {
          repro::pack_bf16(v[0][0], v[0][1]), repro::pack_bf16(v[0][2], v[0][3]),
          repro::pack_bf16(v[1][0], v[1][1]), repro::pack_bf16(v[1][2], v[1][3])};
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, xt + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLdP +
                                         dp * 16 + (lane / 16) * 8);
        repro::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        repro::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled by key tile kt + 2
  }
  repro::cp_async_wait<0>();  // the empty group past the diagonal

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + ri[r];
    if (ri[r] >= Q || t >= S) continue;
    bf16* row = out + (((long long)b * S + t) * H + hh) * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = n * 8 + 2 * t4;
      if ((P & 1) == 0 && p + 1 < P) {
        *reinterpret_cast<uint32_t*>(row + p) = repro::pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        if (p < P) row[p] = __float2bfloat16_rn(o[n][2 * r]);
        if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(o[n][2 * r + 1]);
      }
    }
  }
}

inline size_t output_smem_f32(int N, int Q) {
  return sizeof(float) * (2 * (size_t)N * kLd + (size_t)kTile * kMaxP + (size_t)kTile * kLd +
                          2 * (size_t)Q);
}

__global__ void __launch_bounds__(kThreads)
    chunk_output_f32(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ states,
                     float* __restrict__ out, int S, int H, int P, int N, int Q, int nc,
                     long long x_sb, long long x_st, long long b_sb, long long b_st,
                     long long c_sb, long long c_st) {
  extern __shared__ float smem[];
  float* ct = smem;                // [N][kLd]: C^T of the query tile
  float* bt = ct + N * kLd;        // [N][kLd]: B^T of a key tile
  float* xs = bt + N * kLd;        // [kTile][kMaxP]: x of a key tile
  float* ss = xs + kTile * kMaxP;  // [kTile][kLd]: scaled, masked scores
  float* l_s = ss + kTile * kLd;   // [Q]
  float* d_s = l_s + Q;            // [Q]

  const int hh = blockIdx.x, b = blockIdx.y / nc, c = blockIdx.y % nc;
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int i0 = qi * kTile, t0 = c * Q;
  const int t_end = min(Q, i0 + kTile);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* xb = x + b * x_sb + t0 * x_st + hh * P;

  load_dt(d_s, dt + ((long long)b * S + t0) * H + hh, H, t0, t_end, S);
  load_transposed(ct, Cm + b * c_sb + (t0 + i0) * c_st, c_st, tile_rows(i0, Q, S, t0), N);
  __syncthreads();
  if (tid < 32) log_decay(l_s, d_s, t_end, A[hh]);
  __syncthreads();

  float acc[4][4];  // rows i0 + ty + 16 a, columns tx + 16 q
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
  if (c > 0) {  // exp(L_i) C_i . H_c
    const float* h_src = states + ((long long)(b * (nc - 1) + c - 1) * H + hh) * N * kMaxP;
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = ct[n * kLd + ty + 16 * a];
#pragma unroll
      for (int q = 0; q < 4; ++q) hv[q] = h_src[n * kMaxP + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = __fmaf_rn(cv[a], hv[q], acc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float e = i < t_end ? expf(l_s[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = __fmul_rn(acc[a][q], e);
    }
  }

  for (int j0 = 0; j0 <= i0; j0 += kTile) {
    const int rows = tile_rows(j0, Q, S, t0);
    load_transposed(bt, Bm + b * b_sb + (t0 + j0) * b_st, b_st, rows, N);
    for (int e = tid; e < kTile * kMaxP; e += kThreads) {
      const int j = e / kMaxP, p = e % kMaxP;
      xs[e] = (j < rows && p < P) ? xb[(j0 + j) * x_st + p] : 0.f;
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[a][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = ct[n * kLd + ty + 16 * a];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bt[n * kLd + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[a][q] = __fmaf_rn(cv[a], bv[q], sc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx + 16 * q;
        // select before the exponential: above the diagonal L_i - L_j > 0
        const bool keep = j <= i && i < t_end;
        ss[(ty + 16 * a) * kLd + tx + 16 * q] =
            keep ? __fmul_rn(__fmul_rn(sc[a][q], expf(l_s[i] - l_s[j])), d_s[j]) : 0.f;
      }
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float sv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = ss[(ty + 16 * a) * kLd + j];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[j * kMaxP + tx + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = __fmaf_rn(sv[a], xv[q], acc[a][q]);
    }
    __syncthreads();  // bt, xs and ss are rewritten by the next key tile
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a, t = t0 + i;
    if (i >= Q || t >= S) continue;
    float* row = out + (((long long)b * S + t) * H + hh) * P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tx + 16 * q;
      if (p < P) row[p] = acc[a][q];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// What a launch needs to know of its device, looked up once per device: the
// shared-memory limit, and a private stream-ordered pool for the chunk
// states that keeps its memory between calls (release threshold: unlimited).
struct Device {
  int max_optin = 0;
  cudaMemPool_t pool = nullptr;
};

cudaError_t device_info(const Device** out) {
  constexpr int kDevices = 64;
  static Device devices[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (d.pool == nullptr) {
    err = cudaDeviceGetAttribute(&d.max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t pool;
    if ((err = cudaMemPoolCreate(&pool, &props)) != cudaSuccess) return err;
    uint64_t keep = UINT64_MAX;
    err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) return err;
    d.pool = pool;
  }
  *out = &d;
  return cudaSuccess;
}

bool rows_aligned(const void* p, long long sb, int Bt, long long st, int S) {
  return repro::aligned16(p) && (Bt == 1 || sb % 8 == 0) && (S == 1 || st % 8 == 0);
}

struct Call {
  const void *x, *dt, *B, *C;
  const float* A;
  void* out;
  int Bt, S, H, P, N, Q, nc, q_tiles;
  long long x_sb, x_st, b_sb, b_st, c_sb, c_st;
};

cudaError_t run_bf16(const Call& k, float* states, bf16* h_bf, float* decay, int max_optin,
                     cudaStream_t s) {
  const bool vec_x = (k.P % 8 == 0) && rows_aligned(k.x, k.x_sb, k.Bt, k.x_st, k.S);
  const bool vec_b = rows_aligned(k.B, k.b_sb, k.Bt, k.b_st, k.S);
  const bool vec_c = rows_aligned(k.C, k.c_sb, k.Bt, k.c_st, k.S);
  const auto* x = static_cast<const bf16*>(k.x);
  const auto* dt = static_cast<const bf16*>(k.dt);
  const auto* Bm = static_cast<const bf16*>(k.B);
  cudaError_t err;
  if (k.nc > 1) {
    const size_t smem =
        sizeof(bf16) * 4 * kTile * kLdP + sizeof(float) * (k.Q + round_up(k.Q, kTile));
    if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
    if ((err = allow_smem<chunk_state_bf16>(max_optin)) != cudaSuccess) return err;
    const dim3 grid((k.N + kTile - 1) / kTile, k.H, k.Bt * (k.nc - 1));
    chunk_state_bf16<<<grid, kTcThreads, smem, s>>>(
        x, dt, k.A, Bm, states, h_bf, decay, k.S, k.H, k.P, k.N, k.Q, k.nc, k.x_sb, k.x_st,
        k.b_sb, k.b_st, vec_x, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (k.nc > 2) {
    const int NP = k.N * kMaxP;
    const dim3 grid((NP + kPassThreads - 1) / kPassThreads, k.H, k.Bt);
    state_passing<<<grid, kPassThreads, 0, s>>>(states, h_bf, decay, k.H, NP, k.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = output_smem_bf16(k.Q);
  if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
  if ((err = allow_smem<chunk_output_bf16>(max_optin)) != cudaSuccess) return err;
  const dim3 grid(k.H, k.Bt * k.nc, k.q_tiles);
  chunk_output_bf16<<<grid, kTcThreads, smem, s>>>(
      x, dt, k.A, Bm, static_cast<const bf16*>(k.C), h_bf, static_cast<bf16*>(k.out), k.S, k.H,
      k.P, k.N, k.Q, k.nc, k.x_sb, k.x_st, k.b_sb, k.b_st, k.c_sb, k.c_st, vec_x, vec_b, vec_c);
  return cudaGetLastError();
}

cudaError_t run_f32(const Call& k, float* states, float* decay, int max_optin, cudaStream_t s) {
  const auto* x = static_cast<const float*>(k.x);
  const auto* dt = static_cast<const float*>(k.dt);
  const auto* Bm = static_cast<const float*>(k.B);
  cudaError_t err;
  if (k.nc > 1) {
    const size_t smem = sizeof(float) * (kTile * kTile + kTile * kMaxP + 2 * (size_t)k.Q);
    if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
    if ((err = allow_smem<chunk_state_f32>(max_optin)) != cudaSuccess) return err;
    const dim3 grid((k.N + kTile - 1) / kTile, k.H, k.Bt * (k.nc - 1));
    chunk_state_f32<<<grid, kThreads, smem, s>>>(x, dt, k.A, Bm, states, decay, k.S, k.H, k.P,
                                                 k.N, k.Q, k.nc, k.x_sb, k.x_st, k.b_sb,
                                                 k.b_st);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (k.nc > 2) {
    const int NP = k.N * kMaxP;
    const dim3 grid((NP + kPassThreads - 1) / kPassThreads, k.H, k.Bt);
    state_passing<<<grid, kPassThreads, 0, s>>>(states, nullptr, decay, k.H, NP, k.nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t smem = output_smem_f32(k.N, k.Q);
  if (smem > (size_t)max_optin) return cudaErrorInvalidValue;
  if ((err = allow_smem<chunk_output_f32>(max_optin)) != cudaSuccess) return err;
  const dim3 grid(k.H, k.Bt * k.nc, k.q_tiles);
  chunk_output_f32<<<grid, kThreads, smem, s>>>(
      x, dt, k.A, Bm, static_cast<const float*>(k.C), states, static_cast<float*>(k.out), k.S,
      k.H, k.P, k.N, k.Q, k.nc, k.x_sb, k.x_st, k.b_sb, k.b_st, k.c_sb, k.c_st);
  return cudaGetLastError();
}

int launch(const Call& k, bool is_bf16, cudaStream_t s) {
  const Device* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return (int)err;
  // scratch: S_c then H_c in f32 (Bt, nc - 1, H, N, kMaxP), the decays, and
  // for bf16 the bf16 copy of H_c
  void* ws = nullptr;
  float *states = nullptr, *decay = nullptr;
  bf16* h_bf = nullptr;
  if (k.nc > 1) {
    const size_t n_states = (size_t)k.Bt * (k.nc - 1) * k.H * k.N * kMaxP;
    const size_t n_decay = round_up(k.Bt * (k.nc - 1) * k.H, 4);
    const size_t bytes =
        sizeof(float) * (n_states + n_decay) + (is_bf16 ? sizeof(bf16) * n_states : 0);
    if ((err = cudaMallocFromPoolAsync(&ws, bytes, d->pool, s)) != cudaSuccess) return (int)err;
    states = static_cast<float*>(ws);
    decay = states + n_states;
    if (is_bf16) h_bf = reinterpret_cast<bf16*>(decay + n_decay);
  }
  err = is_bf16 ? run_bf16(k, states, h_bf, decay, d->max_optin, s)
                : run_f32(k, states, decay, d->max_optin, s);
  if (ws != nullptr) {
    const cudaError_t free_err = cudaFreeAsync(ws, s);
    if (err == cudaSuccess) err = free_err;
  }
  return (int)err;
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
  const int nc = (S + Q - 1) / Q, q_tiles = (Q + kTile - 1) / kTile;
  if ((long long)Bt * nc > 65535 || H > 65535 || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const Call k{x, dt, B, C, A, out, Bt, S, H, P, N, Q, nc, q_tiles,
               x_sb, x_st, b_sb, b_st, c_sb, c_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return launch(k, false, s);
  if (dtype == repro::kBF16) return launch(k, true, s);
  return (int)cudaErrorInvalidValue;
}
