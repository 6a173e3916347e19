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
// Layout: one block per (query tile of kBQ rows, head, batch). The TPU grid's
// sequential k axis becomes a loop over K/V tiles of kBK keys staged in shared
// memory as fp32. Tiles that the causal or window mask hides entirely are not
// visited: on the TPU they are exact no-ops (alpha = 1, p = 0), so skipping
// them changes no bit of the result.
//
// What bounds it on an H100: at the prefill shape (B = 1, S = 192, H = 32,
// D = 128, bf16, causal) the function needs 4*D operations per unmasked
// (query, key) pair, about 0.3 GFLOP, and moves about 6.3 MB: 1.9 us at
// 3.35 TB/s, 0.3 us at the bf16 tensor-core rate, so device memory bounds it.
// This first version does its products with fp32 FMAs on the CUDA cores, one
// (query, key) score per thread per tile row group, so it runs far from that
// bound; wgmma tiles with TMA loads are the later, fast version.

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
    return dispatch_head_dim<__nv_bfloat16>(D, q, k, v, out, lse, B, Sq, Sk, H, Hkv, causal,
                                            window, softcap, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
