// Fisher-weighted merge kernels for Hopper (sm_90a), paper Eq. 1:
//   merge: out[n] = sum_k w_k F[k,n] theta[k,n] / (sum_k w_k F[k,n] + eps)
//   fold:  num[n] += w F[n] theta[n],  den[n] += w F[n]
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fisher_merge/fisher_merge.py::fisher_merge_2d  (_kernel, line 23)
//   src/repro/kernels/fisher_merge/fisher_merge.py::fisher_fold_2d   (_fold_kernel, line 33)
//
// What bounds them on an H100: bytes, and the fixed cost of a launch. The
// merge reads each of the K client leaves of theta and F once and writes one
// leaf: (2K + 1) N elements for 4K + 2 fp32 operations per column. The fold
// reads num, den (f32), theta and F and writes num and den. An adapter leaf
// of llava-1.5-7b is 262,144 f32 (4096 x 64): a merge of two clients moves
// 5.2 MB of it, 1.6 us at 3.35 TB/s, about what one launch and its tail
// cost. chip_smoke.py computes the bound for each shape it times.
//
// Design: the TPU kernel streams (K, block_n) tiles of one stacked leaf
// through VMEM. Here ONE launch takes a whole adapter tree, and reads each
// client's leaf where it lies (no (K, N) stack is built):
//   * The leaf table travels by value in a __grid_constant__ struct: the
//     K x L theta and F pointers, the L outputs, the K weights as floats and
//     a prefix sum of the leaves' work units. Nothing is copied to the
//     device before the launch, so it is capturable in a CUDA graph. Where
//     the pointers do not fit the 32,764-byte parameter limit (sm_90, CUDA
//     >= 12.1), the host splits the leaves over as few launches as fit.
//   * One flat index runs over the units of every leaf: 16 bytes of each
//     stream a unit (float4 of f32, 8 bf16). A thread finds its leaf by a
//     binary search of the prefix sum and issues the 2 x B vector loads of a
//     batch of B clients before any arithmetic, so each thread keeps 32 B to
//     256 B in flight; the grid is one wave of the kernel's occupancy on
//     the card's SMs, each thread looping over units.
//   * A leaf whose pointers are not all 16-byte aligned, and the last unit
//     of a leaf whose size is not a multiple of the vector width, take a
//     scalar loop in the same kernel, with the same arithmetic.
//   * The loop over k = 0..K-1 runs in that order in fp32 with explicit
//     __fmul_rn / __fadd_rn / __fdiv_rn (no contraction left to the
//     compiler) and no atomics: an element's bits depend only on its column,
//     not on the grid, the batching or the path (the kernel of the first
//     port, one launch per leaf, gave the same bits).
//
// The fold updates num and den IN PLACE (the TPU kernel writes new arrays):
// the server's running sums are its own buffers, and in place it never
// holds a second copy of them. One fold launch takes all leaves of one upload.

#include <atomic>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;   // leaves in one launch
constexpr int kSmallPtrs = 64;   // client leaves (K x L) in the small parameter block
constexpr int kMaxPtrs = 1536;   // ... in the large one: the most clients a leaf may have
constexpr int kParamLimit = 32764;

// The leaves of one launch: element counts, a prefix sum of work units
// (start[L] is the total) and whether the leaf's pointers allow 16-byte
// vector access.
struct Leaves {
  int L;
  long long start[kMaxLeaves + 1];
  long long n[kMaxLeaves];
  int vec[kMaxLeaves];
};

template <int P>
struct MergeParams {
  Leaves leaves;
  int K;
  float eps;
  void* out[kMaxLeaves];
  const void* theta[P];  // [l * K + k]: client k's leaf l
  const void* fisher[P];
  float w[P];
};

struct FoldParams {
  Leaves leaves;
  float w;
  float* num[kMaxLeaves];
  float* den[kMaxLeaves];
  const void* theta[kMaxLeaves];
  const void* fisher[kMaxLeaves];
};

static_assert(sizeof(MergeParams<kMaxPtrs>) <= kParamLimit, "merge parameters too large");
static_assert(sizeof(FoldParams) <= kParamLimit, "fold parameters too large");

// 16 bytes of T as V floats, and back.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* v) {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(repro::pack_bf16(v[0], v[1]), repro::pack_bf16(v[2], v[3]),
                      repro::pack_bf16(v[4], v[5]), repro::pack_bf16(v[6], v[7]));
  }
};

// Streaming 16-byte load: read once, so marked evict-first.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// The leaf holding unit u: the last l with start[l] <= u.
__device__ __forceinline__ int leaf_of(const Leaves& lv, long long u) {
  int lo = 0, hi = lv.L - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lv.start[mid] <= u) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// B: clients whose loads are issued together (2 when K <= 2, else 8).
template <typename T, int P, int B>
__global__ void __launch_bounds__(kThreads)
    fisher_merge_tree(const __grid_constant__ MergeParams<P> p) {
  using Vec = Vec16<T>;
  constexpr int V = Vec::V;
  const long long units = p.leaves.start[p.leaves.L];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < units; u += stride) {
    const int l = leaf_of(p.leaves, u);
    const long long i = (u - p.leaves.start[l]) * V;
    const long long n = p.leaves.n[l];
    const void* const* theta = p.theta + l * p.K;
    const void* const* fisher = p.fisher + l * p.K;
    float num[V], den[V];
#pragma unroll
    for (int e = 0; e < V; ++e) num[e] = den[e] = 0.f;
    if (p.leaves.vec[l] && i + V <= n) {
      for (int k0 = 0; k0 < p.K; k0 += B) {
        uint4 t[B], f[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (k0 + j < p.K) {
            t[j] = ld_stream(static_cast<const T*>(theta[k0 + j]) + i);
            f[j] = ld_stream(static_cast<const T*>(fisher[k0 + j]) + i);
          }
        }
#pragma unroll
        for (int j = 0; j < B; ++j) {
          if (k0 + j < p.K) {
            float tv[V], fv[V];
            Vec::unpack(t[j], tv);
            Vec::unpack(f[j], fv);
            const float wk = p.w[k0 + j];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float wf = __fmul_rn(wk, fv[e]);
              num[e] = __fadd_rn(num[e], __fmul_rn(wf, tv[e]));
              den[e] = __fadd_rn(den[e], wf);
            }
          }
        }
      }
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = __fdiv_rn(num[e], __fadd_rn(den[e], p.eps));
      *reinterpret_cast<uint4*>(static_cast<T*>(p.out[l]) + i) = Vec::pack(o);
    } else {
      const long long m = n - i;  // elements of this unit: V, or fewer at the leaf's end
      for (int k = 0; k < p.K; ++k) {
        const T* tk = static_cast<const T*>(theta[k]) + i;
        const T* fk = static_cast<const T*>(fisher[k]) + i;
        const float wk = p.w[k];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (e < m) {
            const float wf = __fmul_rn(wk, to_f32(fk[e]));
            num[e] = __fadd_rn(num[e], __fmul_rn(wf, to_f32(tk[e])));
            den[e] = __fadd_rn(den[e], wf);
          }
        }
      }
      T* out = static_cast<T*>(p.out[l]) + i;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (e < m) out[e] = from_f32<T>(__fdiv_rn(num[e], __fadd_rn(den[e], p.eps)));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fisher_fold_tree(const __grid_constant__ FoldParams p) {
  using Vec = Vec16<T>;
  constexpr int V = Vec::V;
  const long long units = p.leaves.start[p.leaves.L];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < units; u += stride) {
    const int l = leaf_of(p.leaves, u);
    const long long i = (u - p.leaves.start[l]) * V;
    const long long n = p.leaves.n[l];
    float* num = p.num[l] + i;
    float* den = p.den[l] + i;
    const T* theta = static_cast<const T*>(p.theta[l]) + i;
    const T* fisher = static_cast<const T*>(p.fisher[l]) + i;
    if (p.leaves.vec[l] && i + V <= n) {
      constexpr int R = V / 4;  // float4s of num (and of den) a unit
      uint4 nr[R], dr[R];
      const uint4 tr = ld_stream(theta), fr = ld_stream(fisher);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        nr[r] = reinterpret_cast<const uint4*>(num)[r];
        dr[r] = reinterpret_cast<const uint4*>(den)[r];
      }
      float tv[V], fv[V], nv[V], dv[V];
      Vec::unpack(tr, tv);
      Vec::unpack(fr, fv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Vec16<float>::unpack(nr[r], nv + 4 * r);
        Vec16<float>::unpack(dr[r], dv + 4 * r);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float wf = __fmul_rn(p.w, fv[e]);
        nv[e] = __fadd_rn(nv[e], __fmul_rn(wf, tv[e]));
        dv[e] = __fadd_rn(dv[e], wf);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        reinterpret_cast<uint4*>(num)[r] = Vec16<float>::pack(nv + 4 * r);
        reinterpret_cast<uint4*>(den)[r] = Vec16<float>::pack(dv + 4 * r);
      }
    } else {
      const long long m = n - i;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (e < m) {
          const float wf = __fmul_rn(p.w, to_f32(fisher[e]));
          num[e] = __fadd_rn(num[e], __fmul_rn(wf, to_f32(theta[e])));
          den[e] = __fadd_rn(den[e], wf);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

inline int elem_size(int dtype) { return dtype == repro::kBF16 ? 2 : 4; }

// Blocks for `units` work units: enough for one unit a thread, at most one
// wave of the kernel's occupancy on the current device.
template <auto Kern>
cudaError_t grid_for(long long units, int* blocks) {
  static std::atomic<int> per_sm[repro::kMaxDevices];  // 0: not looked up yet
  int dev = 0, sms = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  int occ = per_sm[dev].load(std::memory_order_relaxed);
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, Kern, kThreads, 0);
    if (err != cudaSuccess) return err;
    occ = occ > 0 ? occ : 1;
    per_sm[dev].store(occ, std::memory_order_relaxed);
  }
  err = repro::device_sms(&sms);
  if (err != cudaSuccess) return err;
  const long long want = (units + kThreads - 1) / kThreads, wave = (long long)sms * occ;
  *blocks = (int)(want < wave ? want : wave);
  return cudaSuccess;
}

// Append leaf `n` elements long to the table; false when it is empty.
template <typename T>
bool add_leaf(Leaves& lv, long long n, bool vec) {
  if (n == 0) return false;
  const int m = lv.L++;
  lv.n[m] = n;
  lv.vec[m] = vec;
  lv.start[m + 1] = lv.start[m] + (n + vec_width<T>() - 1) / vec_width<T>();
  return true;
}

// One launch over leaves [l0, l1) of the K x L tree (theta[k * L + l]).
template <typename T, int P, int B>
cudaError_t launch_merge(const void* const* theta, const void* const* fisher, void* const* out,
                         const long long* n, int K, int L, int l0, int l1, const float* w,
                         float eps, cudaStream_t s, int* launches) {
  MergeParams<P> p;
  p.leaves.L = 0;
  p.leaves.start[0] = 0;
  p.K = K;
  p.eps = eps;
  for (int k = 0; k < K; ++k) p.w[k] = w[k];
  for (int l = l0; l < l1; ++l) {
    const int m = p.leaves.L;
    bool vec = repro::aligned16(out[l]);
    for (int k = 0; k < K; ++k) {
      p.theta[m * K + k] = theta[(long long)k * L + l];
      p.fisher[m * K + k] = fisher[(long long)k * L + l];
      vec = vec && repro::aligned16(p.theta[m * K + k]) && repro::aligned16(p.fisher[m * K + k]);
    }
    p.out[m] = out[l];
    add_leaf<T>(p.leaves, n[l], vec);
  }
  if (p.leaves.L == 0) return cudaSuccess;
  int blocks = 0;
  const cudaError_t err = grid_for<fisher_merge_tree<T, P, B>>(p.leaves.start[p.leaves.L], &blocks);
  if (err != cudaSuccess) return err;
  fisher_merge_tree<T, P, B><<<blocks, kThreads, 0, s>>>(p);
  ++*launches;
  return cudaGetLastError();
}

template <typename T>
cudaError_t merge_tree(const void* const* theta, const void* const* fisher, void* const* out,
                       const long long* n, int K, int L, const float* w, float eps,
                       cudaStream_t s, int* launches) {
  const int per_launch = kMaxPtrs / K < kMaxLeaves ? kMaxPtrs / K : kMaxLeaves;
  for (int l0 = 0; l0 < L; l0 += per_launch) {
    const int l1 = l0 + per_launch < L ? l0 + per_launch : L;
    auto* launch = (l1 - l0) * K > kSmallPtrs ? &launch_merge<T, kMaxPtrs, 8>
                   : K <= 2                   ? &launch_merge<T, kSmallPtrs, 2>
                                              : &launch_merge<T, kSmallPtrs, 8>;
    const cudaError_t err = launch(theta, fisher, out, n, K, L, l0, l1, w, eps, s, launches);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t fold_tree(float* const* num, float* const* den, const void* const* theta,
                      const void* const* fisher, const long long* n, int L, float w,
                      cudaStream_t s, int* launches) {
  for (int l0 = 0; l0 < L; l0 += kMaxLeaves) {
    const int l1 = l0 + kMaxLeaves < L ? l0 + kMaxLeaves : L;
    FoldParams p;
    p.leaves.L = 0;
    p.leaves.start[0] = 0;
    p.w = w;
    for (int l = l0; l < l1; ++l) {
      const int m = p.leaves.L;
      p.num[m] = num[l];
      p.den[m] = den[l];
      p.theta[m] = theta[l];
      p.fisher[m] = fisher[l];
      add_leaf<T>(p.leaves, n[l],
                  repro::aligned16(num[l]) && repro::aligned16(den[l]) &&
                      repro::aligned16(theta[l]) && repro::aligned16(fisher[l]));
    }
    if (p.leaves.L == 0) continue;
    int blocks = 0;
    cudaError_t err = grid_for<fisher_fold_tree<T>>(p.leaves.start[p.leaves.L], &blocks);
    if (err != cudaSuccess) return err;
    fisher_fold_tree<T><<<blocks, kThreads, 0, s>>>(p);
    ++*launches;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The most clients one merge launch takes for a single leaf.
extern "C" int repro_fisher_max_clients() { return kMaxPtrs; }

// Merge L leaves of K clients: theta/fisher[k * L + l] is client k's leaf l
// (n[l] elements, every leaf one dtype), out[l] the merged leaf, w the K
// weights in host memory. *launches counts the kernel launches made.
extern "C" int repro_fisher_merge_tree(const void* const* theta, const void* const* fisher,
                                       void* const* out, const long long* n, int K, int L,
                                       const float* w, float eps, int dtype, void* stream,
                                       int* launches) {
  *launches = 0;
  if (K < 1 || K > kMaxPtrs || L < 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kF32) {
    err = merge_tree<float>(theta, fisher, out, n, K, L, w, eps, s, launches);
  } else if (dtype == repro::kBF16) {
    err = merge_tree<__nv_bfloat16>(theta, fisher, out, n, K, L, w, eps, s, launches);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Fold one upload's L leaves into the f32 running sums num[l], den[l], in place.
extern "C" int repro_fisher_fold_tree(float* const* num, float* const* den,
                                      const void* const* theta, const void* const* fisher,
                                      const long long* n, int L, float w, int dtype, void* stream,
                                      int* launches) {
  *launches = 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    if (n[l] < 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kF32) {
    err = fold_tree<float>(num, den, theta, fisher, n, L, w, s, launches);
  } else if (dtype == repro::kBF16) {
    err = fold_tree<__nv_bfloat16>(num, den, theta, fisher, n, L, w, s, launches);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// One leaf as the L = 1 case of the tree kernel: row k of the (K, N) stacks
// theta and fisher is client k's leaf; w holds the K weights in host memory.
extern "C" int repro_fisher_merge(const void* theta, const void* fisher, const float* w,
                                  void* out, int K, long long N, float eps, int dtype,
                                  void* stream) {
  if (K < 1 || K > kMaxPtrs || N < 0) return (int)cudaErrorInvalidValue;
  const void* rows_t[kMaxPtrs];
  const void* rows_f[kMaxPtrs];
  const long long row = N * elem_size(dtype);
  for (int k = 0; k < K; ++k) {
    rows_t[k] = static_cast<const char*>(theta) + k * row;
    rows_f[k] = static_cast<const char*>(fisher) + k * row;
  }
  int launches = 0;
  return repro_fisher_merge_tree(rows_t, rows_f, &out, &N, K, 1, w, eps, dtype, stream,
                                 &launches);
}

extern "C" int repro_fisher_fold(float* num, float* den, const void* theta, const void* fisher,
                                 float w, long long N, int dtype, void* stream) {
  int launches = 0;
  return repro_fisher_fold_tree(&num, &den, &theta, &fisher, &N, 1, w, dtype, stream, &launches);
}
