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
//     row's live keys in tiles of T = 4096/D keys, loading each tile's K and
//     V rows through the block table into shared memory; the tile math and
//     the combine kernel, grid (Hkv, B), are decode_common.cuh's.
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

#include "decode_common.cuh"

namespace {

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
  using P = Partial<D, GMAX>;
  constexpr int T = P::T;                   // keys per tile
  constexpr int DP = P::DP;
  constexpr int EPV = 16 / sizeof(TKV);     // elements per 16-byte load
  constexpr int RV = D / EPV;               // loads per key row
  constexpr int LPT = T * RV / NT;          // loads per thread per tile
  static_assert(T * RV % NT == 0, "tile shape");

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

  begin_partial(st, q, ((int64_t)b * hkv * g + h * g) * D, g, q_bf16);

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const TKV* kbase = k_pages + head_off;
  const TKV* vbase = v_pages + head_off;
  const int32_t* table = block_table + (int64_t)b * max_blocks;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += T) {
    const int nv = min(T, hi - t0);
    // the tile's K and V rows: 16-byte loads all issued first, then staged
    // to shared memory as fp32 (dequantised)
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
    tile_update(st, g, 0, nv, scale, soft_cap);
  }
  end_partial(st, part_acc, part_ml,
              ((int64_t)b * hkv + h) * nsplit + split, g);
}

template <typename TKV, int D>
int launch(const void* q, const void* kp, const void* vp,
           const int32_t* lens, const int32_t* table, float* pacc,
           float* pml, int batch, int layer, int num_pages, int block_size,
           int hkv, int g, int max_blocks, int nsplit, int window,
           float scale, float soft_cap, float kv_scale, int q_bf16,
           cudaStream_t stream) {
  return for_group(g, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    paged_decode_partial<TKV, D, GM>
        <<<dim3(nsplit, hkv, batch), NT, 0, stream>>>(
            q, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
            lens, table, pacc, pml, layer, num_pages, block_size, hkv, g,
            max_blocks, window, scale, soft_cap, kv_scale, q_bf16);
  });
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
  if (nsplit < 1 || nsplit > MAX_SPLITS) return -1;
  int rc = -1;
#define NXDI_KV(TKV, DD)                                                    \
  rc = launch<TKV, DD>(q, k_pages, v_pages, ln, tb, pacc, pml, batch,       \
                       layer, num_pages, block_size, hkv, g, max_blocks,    \
                       nsplit, window, scale, soft_cap, kv_scale, q_bf16, st)
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
