// The split-K one-token decode attention of the contiguous kernel
// (decode_attention.cu), and the helpers the paged kernel
// (paged_decode_attention.cu, which has its own fused design) shares with
// it: dtype conversion, 16-byte vectors, warp reductions, the soft-cap.
// The contiguous kernel defines its own partial kernel, which stages a tile
// of K/V rows in shared memory from its cache layout and then calls the
// pieces here; its combine kernel is the one below.
//
// A partial block owns one (row, KV head, split): its G = Hq/Hkv query heads
// share every key it loads. Tiles hold T = 4096/D keys, staged as fp32 rows
// of D + 1 floats (padded against bank conflicts), dead keys as 0. Per tile
// a block computes the G x T scores, updates a per-head online max / sum and
// the G x D accumulator; at the end it writes (m, l, acc) to scratch. The
// combine kernel, one block per (KV head, row), turns each split's (m, l)
// into one weight per head, merges the splits' accumulators with them,
// folds in the active token (new_k/new_v, never read from the cache) and
// the sink, and stores in q's dtype.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -2.3819763e38f;   // finite: exp(NEG_INF - m) == 0
constexpr int NT = 128;                     // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_G = 16;
constexpr int MAX_SPLITS = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// 16 contiguous bytes of one K or V row
template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float load_act(const void* base, int64_t i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(
                       reinterpret_cast<const __nv_bfloat16*>(base)[i])
                 : reinterpret_cast<const float*>(base)[i];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float cap(float s, float soft_cap) {
  return soft_cap > 0.f ? soft_cap * tanhf(s / soft_cap) : s;
}

// Shared memory and accumulators of one partial block.
template <int D, int GMAX>
struct Partial {
  static constexpr int T = 4096 / D;              // keys per tile
  static constexpr int DP = D + 1;                // padded row
  static constexpr int OPT = (GMAX * D + NT - 1) / NT;   // outputs/thread
  float* sK;                                      // T x DP
  float* sV;                                      // T x DP
  float* sQ;                                      // GMAX x D
  float* sP;                                      // GMAX x T
  float* sM;
  float* sL;
  float* sA;
  float acc[OPT];
};

// The group's query rows (zero-padded to GMAX heads) into sQ; (m, l, acc)
// = (NEG_INF, 0, 0), which an empty share keeps: weight 0 in the combine.
// Ends before a barrier the caller places.
template <int D, int GMAX>
__device__ __forceinline__ void begin_partial(Partial<D, GMAX>& st,
                                              const void* q, int64_t q_off,
                                              int g, int q_bf16) {
  for (int i = threadIdx.x; i < GMAX * D; i += NT)
    st.sQ[i] = i / D < g ? load_act(q, q_off + i, q_bf16) : 0.f;
  if (threadIdx.x < GMAX) {
    st.sM[threadIdx.x] = NEG_INF;
    st.sL[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < Partial<D, GMAX>::OPT; ++k) st.acc[k] = 0.f;
}

// One staged tile (after a barrier): keys [t_lo, t_hi) of its T are live
// (at least one), the rest were staged as 0. Scores, online softmax, and
// acc = acc * alpha + P V. Ends with a barrier, so the caller may stage
// the next tile.
template <int D, int GMAX>
__device__ __forceinline__ void tile_update(Partial<D, GMAX>& st, int g,
                                            int t_lo, int t_hi, float scale,
                                            float soft_cap) {
  constexpr int T = Partial<D, GMAX>::T;
  constexpr int DP = Partial<D, GMAX>::DP;
  constexpr int GSTEP = NT / T;             // heads one score pass covers
  static_assert(NT % T == 0, "tile shape");
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // 1. scores of (head, key) pairs: a warp holds one head, 32 keys
  {
    const int t = tid % T;
    const bool live = t >= t_lo && t < t_hi;
    for (int gg = tid / T; gg < g; gg += GSTEP) {
      float s = NEG_INF;
      if (live) {
        const float* qr = st.sQ + gg * D;
        const float* kk = st.sK + t * DP;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kk[d];
        s = cap(dot * scale, soft_cap);
      }
      st.sP[gg * T + t] = s;
    }
  }
  __syncthreads();

  // 2. online softmax: warp w owns heads w, w + NW, ... (the tile max is
  //    finite, so dead keys get p = 0)
  for (int gg = warp; gg < g; gg += NW) {
    float* pr = st.sP + gg * T;
    float mx = NEG_INF;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_old = st.sM[gg];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float p = expf(pr[t] - m_new);
      pr[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      st.sA[gg] = alpha;
      st.sL[gg] = st.sL[gg] * alpha + sum;
      st.sM[gg] = m_new;
    }
  }
  __syncthreads();

  // 3. acc = acc * alpha + P V: a thread owns (head, d) outputs
#pragma unroll
  for (int k = 0; k < Partial<D, GMAX>::OPT; ++k) {
    const int idx = tid + k * NT;
    const int gg = idx / D;
    if (gg < g) {
      const int d = idx % D;
      const float* pr = st.sP + gg * T;
      float a = st.acc[k] * st.sA[gg];
      for (int t = t_lo; t < t_hi; ++t) a += pr[t] * st.sV[t * DP + d];
      st.acc[k] = a;
    }
  }
  __syncthreads();
}

// (m, l, acc) of split `part` = ((b * hkv + h) * nsplit + split).
template <int D, int GMAX>
__device__ __forceinline__ void end_partial(const Partial<D, GMAX>& st,
                                            float* part_acc, float* part_ml,
                                            int64_t part, int g) {
  float* pa = part_acc + part * g * D;
#pragma unroll
  for (int k = 0; k < Partial<D, GMAX>::OPT; ++k) {
    const int idx = threadIdx.x + k * NT;
    if (idx < g * D) pa[idx] = st.acc[k];
  }
  if (threadIdx.x < g) {
    part_ml[(part * g + threadIdx.x) * 2] = st.sM[threadIdx.x];
    part_ml[(part * g + threadIdx.x) * 2 + 1] = st.sL[threadIdx.x];
  }
}

// grid (Hkv, B). q/out (B, Hq, D) and new_k/new_v (B, Hkv, D) in q's dtype
// (q_bf16); sink (Hq,) fp32 or null; part_acc (B, Hkv, splits, G, D) and
// part_ml (B, Hkv, splits, G, 2) from the partial kernel.
__global__ void __launch_bounds__(NT)
decode_combine(const void* __restrict__ q, const void* __restrict__ new_k,
               const void* __restrict__ new_v, const float* __restrict__ sink,
               const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, void* __restrict__ out,
               int hkv, int g, int head_dim, int nsplit, float scale,
               float soft_cap, int q_bf16) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int D = head_dim;
  const int hq = hkv * g;
  const int ns = nsplit * g;
  __shared__ float sSa[MAX_G], sMt[MAX_G], sDen[MAX_G];
  __shared__ float sW[MAX_SPLITS * MAX_G];   // split max, then its weight
  __shared__ float sL[MAX_SPLITS * MAX_G];

  const int64_t part0 = ((int64_t)b * hkv + h) * nsplit;
  const float* pm = part_ml + part0 * g * 2;
  const float* pa = part_acc + part0 * g * D;
  for (int i = tid; i < ns; i += NT) {
    sW[i] = pm[2 * i];
    sL[i] = pm[2 * i + 1];
  }
  // active-token scores (new_k in q's dtype, no kv_scale)
  const int64_t kv_row = ((int64_t)b * hkv + h) * D;
  for (int gg = warp; gg < g; gg += NW) {
    const int64_t q_row = ((int64_t)b * hq + h * g + gg) * D;
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part += load_act(q, q_row + d, q_bf16) *
              load_act(new_k, kv_row + d, q_bf16);
    const float sc = cap(warp_sum(part) * scale, soft_cap);
    if (lane == 0) sSa[gg] = sc;
  }
  __syncthreads();

  if (tid < g) {
    // the sink raises the running max before the final rescale
    float mt = sSa[tid];
    for (int s = 0; s < nsplit; ++s) mt = fmaxf(mt, sW[s * g + tid]);
    float sk = 0.f;
    if (sink != nullptr) {
      sk = sink[h * g + tid];
      mt = fmaxf(mt, sk);
    }
    float den = expf(sSa[tid] - mt);
    for (int s = 0; s < nsplit; ++s)
      den += sL[s * g + tid] * expf(sW[s * g + tid] - mt);
    if (sink != nullptr) den += expf(sk - mt);
    sMt[tid] = mt;
    sDen[tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < ns; i += NT) {
    const int gg = i % g;
    sW[i] = expf(sW[i] - sMt[gg]) / sDen[gg];
  }
  __syncthreads();

  for (int idx = tid; idx < g * D; idx += NT) {
    const int gg = idx / D;
    const int d = idx % D;
    float a = expf(sSa[gg] - sMt[gg]) / sDen[gg] *
              load_act(new_v, kv_row + d, q_bf16);
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      a += sW[s * g + gg] * pa[(int64_t)s * g * D + idx];
    const int64_t oi = ((int64_t)b * hq + h * g) * D + idx;
    if (q_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16(a);
    else
      reinterpret_cast<float*>(out)[oi] = a;
  }
}

// Calls launch(std::integral_constant<int, GMAX>) for the smallest of the
// partial kernel's instantiations GMAX >= g; -1 when g exceeds MAX_G.
template <typename F>
int for_group(int g, F&& launch) {
  if (g < 1) return -1;
  if (g <= 1) launch(std::integral_constant<int, 1>{});
  else if (g <= 2) launch(std::integral_constant<int, 2>{});
  else if (g <= 4) launch(std::integral_constant<int, 4>{});
  else if (g <= 8) launch(std::integral_constant<int, 8>{});
  else if (g <= MAX_G) launch(std::integral_constant<int, MAX_G>{});
  else return -1;
  return 0;
}

// The combine launch after a partial launch; returns cudaGetLastError().
inline int launch_combine(const void* q, const void* new_k, const void* new_v,
                          const void* sink, const float* part_acc,
                          const float* part_ml, void* out, int batch,
                          int hkv, int g, int head_dim, int nsplit,
                          float scale, float soft_cap, int q_bf16,
                          cudaStream_t stream) {
  decode_combine<<<dim3(hkv, batch), NT, 0, stream>>>(
      q, new_k, new_v, static_cast<const float*>(sink), part_acc, part_ml,
      out, hkv, g, head_dim, nsplit, scale, soft_cap, q_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
