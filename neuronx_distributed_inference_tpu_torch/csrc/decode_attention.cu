// Contiguous-cache one-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/decode_attention.py::_decode_kernel of the JAX
// package (neuronx_distributed_inference_tpu/ops/decode_attention.py:41-261,
// wrapper decode_attention_stacked): one query token per row; each KV head's
// GQA group of G = Hq/Hkv query heads attends over the row's prior keys
// [max(0, pos - w + 1), pos) of layer `layer` of the stacked cache (w = 0: no
// window), plus the active token (new_k/new_v, folded in from registers,
// never read from the cache). fp32 online softmax; options: dynamic sliding
// window, tanh soft-cap, per-head sink that enters the denominator only,
// kv_scale dequantisation on load.
//
// What bounds it on the H100: the bytes of the live K/V. Each key and value
// row is used once per KV head, for G query heads: about 2*G flops per byte
// loaded, far below the ~295 flop/byte the card needs before compute matters,
// so it is HBM-bound: sum_b live keys x Hkv x D x 2 x element size, at
// 3.35 TB/s.
// What the design does about that: it reads only each row's live keys, each
// of them once per KV head (the G query heads of the group share one block),
// with 16-byte loads, and splits the live keys over several blocks (split-K)
// so that B*Hkv*splits blocks keep the 132 SMs loading even at batch 4:
//
//   partial kernel, grid (splits, Hkv, B): the live keys fall in tiles of
//     T = 4096/D keys aligned to multiples of T; a block walks its share of
//     those tiles, loading K (transposed: each of the D rows holds T
//     adjacent keys, read S-contiguous) and V (T rows of D, read
//     D-contiguous) into shared memory, only the vectors that hold a live
//     key; the tile math and the combine kernel, grid (Hkv, B), are
//     decode_common.cuh's, shared with csrc/paged_decode_attention.cu.
//
// Not yet done: overlapping a tile's loads with the previous tile's math
// (cp.async / TMA), tensor cores.
//
// Layouts (all contiguous):
//   q (B, Hq, D) and out (B, Hq, D): fp32 or bf16 (q_bf16 flag)
//   new_k/new_v (B, Hkv, D): same dtype as q
//   k_cache (L, B, Hkv, D, S) transposed, v_cache (L, B, Hkv, S, D): fp32,
//     bf16 or fp8-e4m3 (template TKV)
//   lens (B,) int32 prior lengths; sink (Hq,) fp32 or null
//   part_acc (B, Hkv, splits, G, D) and part_ml (B, Hkv, splits, G, 2) fp32
//     scratch, allocated by the caller

#include "decode_common.cuh"

namespace {

template <typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(NT)
decode_partial(const void* __restrict__ q, const TKV* __restrict__ k_cache,
               const TKV* __restrict__ v_cache,
               const int32_t* __restrict__ lens, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int layer, int batch, int hkv,
               int g, int seq, int window, float scale, float soft_cap,
               float kv_scale, int q_bf16, int vec_ok) {
  using P = Partial<D, GMAX>;
  constexpr int T = P::T;                   // keys per tile
  constexpr int DP = P::DP;
  constexpr int EPV = 16 / sizeof(TKV);     // elements per 16-byte load
  constexpr int RV = D / EPV;               // V loads per key row
  constexpr int KV_T = T / EPV;             // K loads per D-row of a tile
  constexpr int LPT = T * RV / NT;          // loads per thread per tile
  static_assert(T % EPV == 0 && T * RV % NT == 0, "tile shape");

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  __shared__ float sK[T * DP];
  __shared__ float sV[T * DP];
  __shared__ float sQ[GMAX * D];
  __shared__ float sP[GMAX * T];
  __shared__ float sM[GMAX], sL[GMAX], sA[GMAX];
  P st{sK, sV, sQ, sP, sM, sL, sA, {}};

  // live keys: kpos < pos strictly (the active token is not read from the
  // cache) and, with a window, pos - kpos < window. They fall in the tiles
  // [j0, j0 + n_tiles); this block takes an equal share of those tiles
  const int pos = lens[b];
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  const int j0 = kstart / T;
  const int n_tiles = pos > kstart ? (pos - 1) / T - j0 + 1 : 0;
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int jlo = j0 + split * per;
  const int jhi = min(jlo + per, j0 + n_tiles);

  begin_partial(st, q, ((int64_t)b * hkv * g + h * g) * D, g, q_bf16);

  const int64_t head = ((int64_t)layer * batch + b) * hkv + h;
  const TKV* kbase = k_cache + head * D * seq;     // (D, S) of this head
  const TKV* vbase = v_cache + head * seq * D;     // (S, D) of this head
  __syncthreads();

  for (int j = jlo; j < jhi; ++j) {
    const int t0 = j * T;
    const int t_lo = max(kstart - t0, 0);          // live keys of the tile
    const int t_hi = min(pos - t0, T);
    // 16-byte loads of the vectors that hold a live key, all issued
    // first, then staged to shared memory as fp32 (dequantised); dead keys
    // are staged as 0
    Vec16<TKV> kr[LPT], vr[LPT];
#pragma unroll
    for (int jj = 0; jj < LPT; ++jj) {
      const int i = tid + jj * NT;
      const int d = i / KV_T;
      const int s0 = (i % KV_T) * EPV;
      if (s0 < t_hi && s0 + EPV > t_lo) {
        const TKV* src = kbase + (int64_t)d * seq + t0 + s0;
        if (vec_ok) {
          kr[jj] = *reinterpret_cast<const Vec16<TKV>*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < EPV; ++e)
            kr[jj].v[e] = t0 + s0 + e < seq ? src[e] : TKV(0.f);
        }
      }
      const int t = i / RV;
      if (t >= t_lo && t < t_hi)
        vr[jj] = *reinterpret_cast<const Vec16<TKV>*>(
            vbase + (int64_t)(t0 + t) * D + (i % RV) * EPV);
    }
#pragma unroll
    for (int jj = 0; jj < LPT; ++jj) {
      const int i = tid + jj * NT;
      const int d = i / KV_T;
      const int s0 = (i % KV_T) * EPV;
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const int t = s0 + e;
        sK[t * DP + d] =
            t >= t_lo && t < t_hi ? to_f(kr[jj].v[e]) * kv_scale : 0.f;
      }
      const int t = i / RV;
      const bool live = t >= t_lo && t < t_hi;
      float* sv = sV + t * DP + (i % RV) * EPV;
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        sv[e] = live ? to_f(vr[jj].v[e]) * kv_scale : 0.f;
    }
    __syncthreads();
    tile_update(st, g, t_lo, t_hi, scale, soft_cap);
  }
  end_partial(st, part_acc, part_ml,
              ((int64_t)b * hkv + h) * nsplit + split, g);
}

template <typename TKV, int D>
int launch(const void* q, const void* kc, const void* vc,
           const int32_t* lens, float* pacc, float* pml, int batch,
           int layer, int hkv, int g, int seq, int nsplit, int window,
           float scale, float soft_cap, float kv_scale, int q_bf16,
           cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(TKV);
  const int vec_ok = seq % EPV == 0;     // every K row 16-byte aligned
  return for_group(g, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    decode_partial<TKV, D, GM><<<dim3(nsplit, hkv, batch), NT, 0, stream>>>(
        q, static_cast<const TKV*>(kc), static_cast<const TKV*>(vc), lens,
        pacc, pml, layer, batch, hkv, g, seq, window, scale, soft_cap,
        kv_scale, q_bf16, vec_ok);
  });
}

}  // namespace

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp8-e4m3. `batch` is the cache's batch
// (the query batch must equal it). Returns cudaGetLastError() after the two
// launches, or -1 for a shape/dtype the kernel does not take (the Python
// wrapper checks those first).
extern "C" int nxdi_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* new_k, const void* new_v, const void* lens, const void* sink,
    void* part_acc, void* part_ml, void* out, int batch, int layer, int hkv,
    int g, int head_dim, int seq, int nsplit, int window, float scale,
    float soft_cap, float kv_scale, int kv_dtype, int q_bf16, void* stream) {
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLITS) return -1;
  int rc = -1;
#define NXDI_KV(TKV, DD)                                                   \
  rc = launch<TKV, DD>(q, k_cache, v_cache, ln, pacc, pml, batch, layer,   \
                       hkv, g, seq, nsplit, window, scale, soft_cap,       \
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
  return launch_combine(q, new_k, new_v, sink, pacc, pml, out, batch, hkv,
                        g, head_dim, nsplit, scale, soft_cap, q_bf16, st);
}
