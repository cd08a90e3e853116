// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/decode_attention.py::_paged_kernel of the JAX
// package (neuronx_distributed_inference_tpu/ops/decode_attention.py:336-518):
// one query token per row; each KV head's GQA group of G = Hq/Hkv query heads
// attends over the row's prior tokens [0, lens[b]) read from the stacked page
// cache through block_table[b, j], plus the active token (new_k/new_v, folded
// in from registers, never read from the cache). fp32 online softmax; options:
// dynamic sliding window (0 = none), tanh soft-cap, per-head sink that enters
// the denominator only, kv_scale dequantisation on the page load.
//
// What bounds it on the H100: the bytes of the live K/V rows. Each key and
// value row is used once per KV head, for G query heads: about 2*G flops per
// byte loaded, far below the ~295 flop/byte the card needs before compute
// matters, so it is HBM-bound (3.35 TB/s).
// What the design does about that: it reads only the live keys of a row (the
// window's and the prefix's, never the whole table), each of them exactly once
// per KV head (the G query heads of the group share one block), with 16-byte
// loads, and it splits each row's live keys over several blocks (split-K) so
// that B*Hkv*splits blocks keep all 132 SMs loading even at batch 4, a long
// row's blocks each taking about one tile:
//
//   partial kernel, grid (splits, Hkv, B): a block walks its share of the
//     row's live keys in tiles of T = 4096/D keys. Per tile it loads the K and
//     V rows into shared memory (fp32, rows padded against bank conflicts),
//     computes the G x T scores, updates a per-head online max / sum and the
//     G x D accumulator, and finally writes (m, l, acc) to scratch;
//   combine kernel, grid (Hkv, B): turns each split's (m, l) into one
//     weight per head, merges the splits' accumulators with them, folds in
//     the active token and the sink, and stores in q's dtype.
//
// Not yet done: overlapping a tile's loads with the previous tile's math
// (cp.async / TMA), tensor cores for the G x T and G x D products.
//
// Layouts (all contiguous):
//   q (B, Hq, D) and out (B, Hq, D): fp32 or bf16 (q_bf16 flag)
//   new_k/new_v (B, Hkv, D): same dtype as q
//   k_pages/v_pages (L, N, Bs, Hkv, D): fp32, bf16 or fp8-e4m3 (template TKV)
//   lens (B,) int32 prior lengths; block_table (B, max_blocks) int32
//   sink (Hq,) fp32 or null
//   part_acc (B, Hkv, splits, G, D) and part_ml (B, Hkv, splits, G, 2) fp32
//     scratch, allocated by the caller

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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

template <typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(NT)
paged_decode_partial(const void* __restrict__ q,
                     const TKV* __restrict__ k_pages,
                     const TKV* __restrict__ v_pages,
                     const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ block_table,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int layer, int num_pages,
                     int block_size, int hkv, int g, int max_blocks,
                     int window, float scale, float soft_cap, float kv_scale,
                     int q_bf16) {
  constexpr int T = 4096 / D;               // keys per tile
  constexpr int EPV = 16 / sizeof(TKV);     // elements per 16-byte load
  constexpr int RV = D / EPV;               // loads per key row
  constexpr int LPT = T * RV / NT;          // loads per thread per tile
  constexpr int DP = D + 1;                 // padded shared-memory row
  constexpr int GSTEP = NT / T;             // heads one score pass covers
  constexpr int OPT = (GMAX * D + NT - 1) / NT;   // outputs per thread
  static_assert(T * RV % NT == 0 && NT % T == 0, "tile shape");

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int hq = hkv * g;

  __shared__ float sK[T * DP];
  __shared__ float sV[T * DP];
  __shared__ float sQ[GMAX * D];
  __shared__ float sP[GMAX * T];            // scores, then probabilities
  __shared__ float sM[GMAX], sL[GMAX], sA[GMAX];

  // live keys: kpos < pos strictly (the active token is not read from the
  // cache) and, with a window, pos - kpos < window; this block's share of
  // them is [lo, hi): an equal share of the row, but at least half a tile,
  // so a short row leaves its surplus blocks empty (they exit at once)
  // instead of spreading a few keys over each
  const int pos = lens[b];
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  const int n_live = max(pos - kstart, 0);
  const int per = max((n_live + nsplit - 1) / nsplit, T / 2);
  const int lo = kstart + split * per;
  const int hi = min(lo + per, pos);

  for (int i = tid; i < GMAX * D; i += NT) {
    const int gg = i / D;
    sQ[i] = gg < g ? load_act(q, ((int64_t)b * hq + h * g) * D + i, q_bf16)
                   : 0.f;
  }
  // an empty share keeps (m, l, acc) = (NEG_INF, 0, 0): weight 0 in the
  // combine
  if (tid < GMAX) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const TKV* kbase = k_pages + head_off;
  const TKV* vbase = v_pages + head_off;
  const int32_t* table = block_table + (int64_t)b * max_blocks;

  float acc[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) acc[k] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += T) {
    const int nv = min(T, hi - t0);
    // 1. the tile's K and V rows: 16-byte loads all issued first, then
    //    staged to shared memory as fp32 (dequantised)
    Vec16<TKV> kr[LPT], vr[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * NT;
      const int t = i / RV;
      if (t < nv) {
        const int kp = t0 + t;
        const int64_t off = (int64_t)table[kp / block_size] * page_stride +
                            (int64_t)(kp % block_size) * row_stride +
                            (i % RV) * EPV;
        kr[j] = *reinterpret_cast<const Vec16<TKV>*>(kbase + off);
        vr[j] = *reinterpret_cast<const Vec16<TKV>*>(vbase + off);
      }
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = tid + j * NT;
      const int t = i / RV;
      float* sk = sK + t * DP + (i % RV) * EPV;
      float* sv = sV + t * DP + (i % RV) * EPV;
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        sk[e] = t < nv ? to_f(kr[j].v[e]) * kv_scale : 0.f;
        sv[e] = t < nv ? to_f(vr[j].v[e]) * kv_scale : 0.f;
      }
    }
    __syncthreads();

    // 2. scores of (head, key) pairs: a warp holds one head, 32 keys
    {
      const int t = tid % T;
      for (int gg = tid / T; gg < g; gg += GSTEP) {
        float s = NEG_INF;
        if (t < nv) {
          const float* qr = sQ + gg * D;
          const float* kk = sK + t * DP;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qr[d] * kk[d];
          s = cap(dot * scale, soft_cap);
        }
        sP[gg * T + t] = s;
      }
    }
    __syncthreads();

    // 3. online softmax: warp w owns heads w, w + NW, ...
    for (int gg = warp; gg < g; gg += NW) {
      float mx = NEG_INF;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sP[gg * T + t]);
      mx = warp_max(mx);
      const float m_old = sM[gg];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float p = t < nv ? expf(sP[gg * T + t] - m_new) : 0.f;
        sP[gg * T + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[gg] = alpha;
        sL[gg] = sL[gg] * alpha + sum;
        sM[gg] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V: a thread owns (head, d) outputs
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      const int idx = tid + k * NT;
      const int gg = idx / D;
      if (gg < g) {
        const int d = idx % D;
        const float* pr = sP + gg * T;
        float a = acc[k] * sA[gg];
        for (int t = 0; t < nv; ++t) a += pr[t] * sV[t * DP + d];
        acc[k] = a;
      }
    }
    __syncthreads();
  }

  const int64_t part = ((int64_t)b * hkv + h) * nsplit + split;
  float* pa = part_acc + part * g * D;
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int idx = tid + k * NT;
    if (idx < g * D) pa[idx] = acc[k];
  }
  if (tid < g) {
    part_ml[(part * g + tid) * 2] = sM[tid];
    part_ml[(part * g + tid) * 2 + 1] = sL[tid];
  }
}

__global__ void __launch_bounds__(NT)
paged_decode_combine(const void* __restrict__ q,
                     const void* __restrict__ new_k,
                     const void* __restrict__ new_v,
                     const float* __restrict__ sink,
                     const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     void* __restrict__ out, int hkv, int g, int head_dim,
                     int nsplit, float scale, float soft_cap, int q_bf16) {
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

template <typename TKV, int D, int GMAX>
void launch_partial(const void* q, const void* kp, const void* vp,
                    const int32_t* lens, const int32_t* table, float* pacc,
                    float* pml, int batch, int layer, int num_pages,
                    int block_size, int hkv, int g, int max_blocks,
                    int nsplit, int window, float scale, float soft_cap,
                    float kv_scale, int q_bf16, cudaStream_t stream) {
  dim3 grid(nsplit, hkv, batch);
  paged_decode_partial<TKV, D, GMAX><<<grid, NT, 0, stream>>>(
      q, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp), lens,
      table, pacc, pml, layer, num_pages, block_size, hkv, g, max_blocks,
      window, scale, soft_cap, kv_scale, q_bf16);
}

template <typename TKV, int D>
int dispatch_g(const void* q, const void* kp, const void* vp,
               const int32_t* lens, const int32_t* table, float* pacc,
               float* pml, int batch, int layer, int num_pages,
               int block_size, int hkv, int g, int max_blocks, int nsplit,
               int window, float scale, float soft_cap, float kv_scale,
               int q_bf16, cudaStream_t stream) {
#define NXDI_G(GM)                                                         \
  launch_partial<TKV, D, GM>(q, kp, vp, lens, table, pacc, pml, batch,     \
                             layer, num_pages, block_size, hkv, g,         \
                             max_blocks, nsplit, window, scale, soft_cap,  \
                             kv_scale, q_bf16, stream)
  if (g <= 1) NXDI_G(1);
  else if (g <= 2) NXDI_G(2);
  else if (g <= 4) NXDI_G(4);
  else if (g <= 8) NXDI_G(8);
  else if (g <= MAX_G) NXDI_G(MAX_G);
  else return -1;
#undef NXDI_G
  return 0;
}

}  // namespace

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp8-e4m3. Returns cudaGetLastError()
// after the two launches, or -1 for a shape/dtype the kernel does not take
// (the Python wrapper checks those first).
extern "C" int nxdi_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* new_k, const void* new_v, const void* lens,
    const void* block_table, const void* sink, void* part_acc,
    void* part_ml, void* out, int batch, int layer, int num_pages,
    int block_size, int hkv, int g, int head_dim, int max_blocks,
    int nsplit, int window, float scale, float soft_cap, float kv_scale,
    int kv_dtype, int q_bf16, void* stream) {
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const int32_t* tb = static_cast<const int32_t*>(block_table);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLITS || g < 1 || g > MAX_G) return -1;
  int rc = -1;
#define NXDI_KV(TKV, DD)                                                    \
  rc = dispatch_g<TKV, DD>(q, k_pages, v_pages, ln, tb, pacc, pml, batch,   \
                           layer, num_pages, block_size, hkv, g,            \
                           max_blocks, nsplit, window, scale, soft_cap,     \
                           kv_scale, q_bf16, st)
  if (head_dim == 64) {
    if (kv_dtype == 0) NXDI_KV(float, 64);
    else if (kv_dtype == 1) NXDI_KV(__nv_bfloat16, 64);
    else if (kv_dtype == 2) NXDI_KV(__nv_fp8_e4m3, 64);
  } else if (head_dim == 128) {
    if (kv_dtype == 0) NXDI_KV(float, 128);
    else if (kv_dtype == 1) NXDI_KV(__nv_bfloat16, 128);
    else if (kv_dtype == 2) NXDI_KV(__nv_fp8_e4m3, 128);
  }
#undef NXDI_KV
  if (rc != 0) return -1;
  dim3 grid(hkv, batch);
  paged_decode_combine<<<grid, NT, 0, st>>>(
      q, new_k, new_v, static_cast<const float*>(sink), pacc, pml, out, hkv,
      g, head_dim, nsplit, scale, soft_cap, q_bf16);
  return static_cast<int>(cudaGetLastError());
}
