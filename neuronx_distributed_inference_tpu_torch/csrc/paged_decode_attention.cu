// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/decode_attention.py::_paged_kernel of the JAX
// package (neuronx_distributed_inference_tpu/ops/decode_attention.py:336-518):
// one query token per row; each KV head's GQA group of G = Hq/Hkv query heads
// attends over the row's prior tokens [0, lens[b]) read from the stacked page
// cache through block_table[b, j], plus the active token (new_k/new_v, never
// read from the cache). fp32 online softmax; options: dynamic sliding window
// (0 = none), tanh soft-cap, per-head sink that enters the denominator only,
// kv_scale dequantisation of the pages.
//
// What bounds it on the H100: the bytes of the live K/V rows. Each key and
// value row is used once per KV head, for G query heads: about 2*G flops per
// byte loaded, far below the ~295 flop/byte the card needs before compute
// matters, so it is HBM-bound (3.35 TB/s). At serving batch sizes the live
// bytes are a few MB, so what it actually pays is latency: the dependent
// loads lens -> block table -> K/V, the instructions of the tile math,
// barriers, and launches.
// What the design does about that (decode_common.cuh holds the parts it
// shares with the contiguous kernel): ONE launch, grid (splits, Hkv x C, B),
// C = ceil(G / 16) chunks of at most 16 query heads a KV head (a group of
// at most 16 is one chunk; a multi-query group of 48 or 71 is 3 or 5, each
// chunk's block loading the KV head's keys, past the first from L2).
// Each block takes an equal share of its row's live keys (split-K, at
// least 2048/D keys, so B*Hkv*splits blocks keep the SMs loading at batch
// 4); blocks whose share is empty exit at once (a row with no live key
// keeps one block, for its merge). A block walks its share in tiles of 32
// keys:
//   - cp.async copies each tile's K and V rows (16-byte pieces, addresses
//     from the block table) straight into a 3-stage ring in shared memory,
//     in the cache's own dtype (a row's pieces XOR-swizzled by the row
//     index: conflict-free 16-byte and ldmatrix reads with no padding, so 8
//     blocks fit an SM). Two tiles are in flight while one is used, and the
//     stage hand-off is the only block barrier of a tile.
//   - bf16 pages with bf16 queries (the serving path) run the tile math on
//     the tensor cores (paged_decode_mma): a chunk's <= 16 query heads are
//     the rows of mma.sync tiles, warp w takes keys 8w .. 8w + 7 of a tile,
//     S = Q K^T by m16n8k16 (K rows read by a plain ldmatrix: a page row
//     is one key's D values), fp32 online softmax per head in registers,
//     O += P V by m16n8k8 with P = bf16(p) + bf16(p - bf16(p)) (two
//     products: the probabilities keep ~16 bits), and the warps' states
//     merge through shared memory at the end. Other dtypes (fp32, fp8
//     pages, fp32 queries) run on the CUDA cores (paged_decode_simt): a
//     warp owns a query head, a lane scores one key, then owns D/32 output
//     columns of P V; values are converted to fp32 when used and kv_scale
//     multiplies the score and the accumulator once.
//   - The combine is fused: a block writes its split's (m, l, acc) to the
//     scratch and counts itself on its (row, KV head)'s counter with a
//     release atomic after a block barrier; the last of the row's blocks
//     with keys merges their splits (with the active token, whose columns
//     each block loads when it starts, and the sink), stores the output,
//     and puts the counter back to 0 for the next launch (so CUDA-graph
//     replays see 0).
//
// Layouts (all contiguous):
//   q (B, Hq, D) and out (B, Hq, D): fp32 or bf16 (q_bf16 flag)
//   new_k/new_v (B, Hkv, D): same dtype as q
//   k_pages/v_pages (L, N, Bs, Hkv, D): fp32, bf16 or fp8-e4m3 (template TKV)
//   lens (B,) int32 prior lengths; block_table (B, max_blocks) int32
//   sink (Hq,) fp32 or null
//   part_acc (B, Hkv, splits, G, D) and part_ml (B, Hkv, splits, G, 2) fp32
//     scratch; counters (B * Hkv * C) int32, zero before and after each
//     launch;
//     all allocated by the caller

#include "decode_common.cuh"

namespace {

constexpr int PSTAGES = 3;       // ring stages

// a tile's K rows, then its V rows: PT rows of one key's D values each
template <typename TKV, int D>
struct PagedTile {
  using Rows = SwzRows<D * (int)sizeof(TKV)>;
  static constexpr int STAGE = 2 * PT * Rows::ROW_BYTES;
  static constexpr int BYTES = PSTAGES * STAGE;
};

// Tile i of the share into stage i % PSTAGES with cp.async (K rows, then
// V rows, addresses through the block table), then one commit (an empty
// group past the last tile keeps the count). ZFILL: dead rows of the tile
// are zero-filled (the tensor-core path multiplies them by p = 0).
template <typename TKV, int D, bool ZFILL>
__device__ __forceinline__ void issue_tile(
    char* ring, int i, const Share& sh, const TKV* k_pages,
    const TKV* v_pages, const int32_t* table, int block_size,
    int64_t page_stride, int64_t row_stride, int64_t head_off) {
  using L = PagedTile<TKV, D>;
  using R = typename L::Rows;
  constexpr int EPV = 16 / sizeof(TKV);
  if (i < sh.n_tiles) {
    char* st = ring + (i % PSTAGES) * L::STAGE;
    const int t0 = sh.t0 + i * PT;
    for (int c = threadIdx.x; c < PT * R::CPR; c += NT) {
      const int t = c / R::CPR;
      const int kp = t0 + t;
      const int so = R::at(t, c % R::CPR);
      if (kp < sh.hi) {
        const int64_t off = (int64_t)table[kp / block_size] * page_stride +
                            (int64_t)(kp % block_size) * row_stride +
                            head_off + (c % R::CPR) * EPV;
        cp_async16(st + so, k_pages + off);
        cp_async16(st + PT * R::ROW_BYTES + so, v_pages + off);
      } else if (ZFILL) {
        cp_async16(st + so, k_pages, false);
        cp_async16(st + PT * R::ROW_BYTES + so, v_pages, false);
      }
    }
  }
  cp_async_commit();
}

// One warp's 8 keys kb .. kb + 7 of a tile, on the tensor cores: the
// scores c (16 heads x 8 keys; c0, c1 head lane / 4, keys kb + 2 (lane % 4)
// + {0, 1}; c2, c3 head lane / 4 + 8) become probabilities (keys outside
// [tlo, thi) overwritten with NEG_INF, never added to: a dead key's score
// may be anything, NaN included), the per-head online softmax (m, l) of
// this thread's keys moves on, and O += P V, P = bf16(p) + bf16(p -
// bf16(p)) in two m16n8k8 products (the probabilities keep ~16 bits). V:
// the tile's PT rows of D bf16 at vt, laid out as SwzRows<2 D>; its dead
// rows must hold zeros (mma multiplies them by p = 0).
template <int D>
__device__ __forceinline__ void mma_update(const float (&c)[4], int kb,
                                           int tlo, int thi, float ks,
                                           float soft_cap, float (&m)[2],
                                           float (&l)[2],
                                           float (&o)[D / 8][4],
                                           const char* vt) {
  using VT = SwzRows<2 * D>;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  float p[4], alpha[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = kb + 2 * tq + (e & 1);
    p[e] = t >= tlo && t < thi ? cap(c[e] * ks, soft_cap) : NEG_INF;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(p[2 * r], p[2 * r + 1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    p[2 * r] = expf(p[2 * r] - m_new);       // dead keys: 0
    p[2 * r + 1] = expf(p[2 * r + 1] - m_new);
    l[r] = l[r] * alpha[r] + p[2 * r] + p[2 * r + 1];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // P as m16n8k8 A fragments (the score layout), hi and lo parts
  const uint32_t h0 = pack_bf16(p[0], p[1]);
  const uint32_t h1 = pack_bf16(p[2], p[3]);
  const uint32_t l0 = pack_bf16_rest(p[0], p[1], h0);
  const uint32_t l1 = pack_bf16_rest(p[2], p[3], h1);
#pragma unroll
  for (int n4 = 0; n4 < D / 32; ++n4) {
    uint32_t v[4];
    ldsm_x4_t(v, vt + VT::at(kb + (lane & 7), 4 * n4 + (lane >> 3)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_1688(o[4 * n4 + j], h0, h1, v[j]);
      mma_1688(o[4 * n4 + j], l0, l1, v[j]);
    }
  }
}

#define NXDI_PAGED_PARAMS                                                 \
  const void *__restrict__ q, const TKV *__restrict__ k_pages,            \
      const TKV *__restrict__ v_pages, const void *__restrict__ new_k,    \
      const void *__restrict__ new_v, const int32_t *__restrict__ lens,   \
      const int32_t *__restrict__ block_table,                            \
      const float *__restrict__ sink, float *__restrict__ part_acc,       \
      float *__restrict__ part_ml, int *__restrict__ counters,            \
      void *__restrict__ out, int layer, int num_pages, int block_size,   \
      int hkv, int g, int max_blocks, int window, float scale,            \
      float soft_cap, float kv_scale, int q_bf16

// CUDA cores: fp32 or fp8 pages, or fp32 queries.
template <typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(NT)
paged_decode_simt(NXDI_PAGED_PARAMS) {
  using L = PagedTile<TKV, D>;
  using R = typename L::Rows;
  constexpr int HPW = (GMAX + NW - 1) / NW;    // heads per warp
  constexpr int DPL = D / 32;                  // output columns per lane
  constexpr int EPV = 16 / sizeof(TKV);        // elements per 16 bytes

  extern __shared__ __align__(16) char ring[];
  __shared__ __align__(16) float sQ[GMAX * D];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const Chunk ck = chunk_of(g);
  const int h = ck.h;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Share sh = share_of(lens[b], window, split, nsplit, 2048 / D, 1);
  if (split >= sh.n_part) return;

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const int32_t* table = block_table + (int64_t)b * max_blocks;
  const Active<D, GMAX> act =
      active_token<D, GMAX>(q, new_k, new_v, b, ck, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, false>(ring, i, sh, k_pages, v_pages, table,
                              block_size, page_stride, row_stride,
                              head_off);
  };
  for (int i = 0; i < PSTAGES - 1; ++i) issue(i);

  const int64_t q_off = ((int64_t)b * hkv * g + (int64_t)h * g + ck.g0) * D;
  for (int i = tid; i < GMAX * D; i += NT)
    sQ[i] = i / D < ck.gc ? load_act(q, q_off + i, q_bf16) : 0.f;

  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
  }
  const float ks = scale * kv_scale;

  for (int i = 0; i < sh.n_tiles; ++i) {
    cp_async_wait<PSTAGES - 2>();
    __syncthreads();      // tile i (and sQ) visible; tile i - 1 consumed
    issue(i + PSTAGES - 1);
    const char* st = ring + (i % PSTAGES) * L::STAGE;
    const int nv = min(PT, sh.hi - (sh.t0 + i * PT));
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int gg = warp + j * NW;
      if (gg >= ck.gc) break;
      // score of key `lane`
      float s = NEG_INF;
      if (lane < nv) {
        const float4* qr = reinterpret_cast<const float4*>(sQ + gg * D);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < R::CPR; ++c) {
          const Vec16<TKV> x =
              *reinterpret_cast<const Vec16<TKV>*>(st + R::at(lane, c));
#pragma unroll
          for (int e4 = 0; e4 < EPV / 4; ++e4) {
            const float4 qv = qr[c * EPV / 4 + e4];
            dot += qv.x * to_f(x.v[4 * e4]) + qv.y * to_f(x.v[4 * e4 + 1]) +
                   qv.z * to_f(x.v[4 * e4 + 2]) +
                   qv.w * to_f(x.v[4 * e4 + 3]);
          }
        }
        s = cap(dot * ks, soft_cap);
      }
      simt_update<TKV, D>(s, m[j], l[j], acc[j], st + PT * R::ROW_BYTES, 0,
                          nv);
    }
  }

  simt_write_split<D, HPW>(m, l, acc, part_acc, part_ml,
                           ((int64_t)b * hkv + h) * nsplit + split, g, ck,
                           kv_scale);
  merge_tail<D, GMAX>(act, sink, part_acc, part_ml, counters, out, b, ck,
                      hkv, g, nsplit, sh.n_part, scale, soft_cap, q_bf16,
                      &s_last);
}

// Tensor cores: bf16 pages and bf16 queries, a chunk of <= 16 heads.
template <int D, typename TKV = __nv_bfloat16>
__global__ void __launch_bounds__(NT)
paged_decode_mma(NXDI_PAGED_PARAMS) {
  using L = PagedTile<TKV, D>;
  using R = typename L::Rows;
  constexpr int KS = D / 16;                   // k-steps of the scores

  extern __shared__ __align__(16) char ring[];
  __shared__ float sM[NW][16], sL[NW][16];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const Chunk ck = chunk_of(g);
  const int h = ck.h;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Share sh = share_of(lens[b], window, split, nsplit, 2048 / D, 1);
  if (split >= sh.n_part) return;

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const int32_t* table = block_table + (int64_t)b * max_blocks;
  const Active<D, MAX_G> act =
      active_token<D, MAX_G>(q, new_k, new_v, b, ck, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, true>(ring, i, sh, k_pages, v_pages, table,
                             block_size, page_stride, row_stride, head_off);
  };
  for (int i = 0; i < PSTAGES - 1; ++i) issue(i);

  uint32_t qa[KS][4];
  load_q_frags<D>(qa, static_cast<const __nv_bfloat16*>(q) +
                          ((int64_t)b * hkv * g + (int64_t)h * g + ck.g0) * D,
                  ck.gc);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                     // this thread's keys' share
  const float ks = scale * kv_scale;
  const int kb = 8 * warp;                     // this warp's keys of a tile

  for (int i = 0; i < sh.n_tiles; ++i) {
    cp_async_wait<PSTAGES - 2>();
    __syncthreads();          // tile i visible; tile i - 1 consumed
    issue(i + PSTAGES - 1);
    const char* st = ring + (i % PSTAGES) * L::STAGE;
    const int nv = min(PT, sh.hi - (sh.t0 + i * PT));
    if (kb >= nv) continue;   // the warp's keys are all dead
    // S (16 heads x 8 keys) = Q K^T: K rows are keys, a plain ldmatrix
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k2 = 0; k2 < KS / 2; ++k2) {
      uint32_t r[4];
      ldsm_x4(r, st + R::at(kb + (lane & 7), 4 * k2 + (lane >> 3)));
      mma_16816(c, qa[2 * k2], r[0], r[1]);
      mma_16816(c, qa[2 * k2 + 1], r[2], r[3]);
    }
    mma_update<D>(c, kb, 0, nv, ks, soft_cap, m, l, o,
                  st + PT * R::ROW_BYTES);
  }

  mma_write_split<D>(m, l, o, ring, sM, sL, part_acc, part_ml,
                     ((int64_t)b * hkv + h) * nsplit + split, g, ck, kv_scale);
  merge_tail<D, MAX_G>(act, sink, part_acc, part_ml, counters, out, b, ck,
                       hkv, g, nsplit, sh.n_part, scale, soft_cap, q_bf16,
                       &s_last);
}

#undef NXDI_PAGED_PARAMS

template <typename TKV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* nk,
           const void* nv, const int32_t* lens, const int32_t* table,
           const float* sink, float* pacc, float* pml, int* counters,
           void* out, int batch, int layer, int num_pages, int block_size,
           int hkv, int g, int max_blocks, int nsplit, int window,
           float scale, float soft_cap, float kv_scale, int q_bf16,
           cudaStream_t stream) {
  const int bytes = PagedTile<TKV, D>::BYTES;
  const int nc = (g + MAX_G - 1) / MAX_G;  // chunks of the group
  const dim3 grid(nsplit, hkv * nc, batch);
  const TKV* k = static_cast<const TKV*>(kp);
  const TKV* v = static_cast<const TKV*>(vp);
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    if (q_bf16) {
      static bool opted_in = false;
      return launch_opted_in(
          paged_decode_mma<D>, opted_in, grid, bytes, stream, q, k, v, nk,
          nv, lens, table, sink, pacc, pml, counters, out, layer, num_pages,
          block_size, hkv, g, max_blocks, window, scale, soft_cap, kv_scale,
          q_bf16);
    }
  }
  int rc = 0;
  const int ok = for_group(g, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    static bool opted_in = false;
    rc = launch_opted_in(
        paged_decode_simt<TKV, D, GM>, opted_in, grid, bytes, stream, q, k,
        v, nk, nv, lens, table, sink, pacc, pml, counters, out, layer,
        num_pages, block_size, hkv, g, max_blocks, window, scale, soft_cap,
        kv_scale, q_bf16);
  });
  return ok != 0 ? -1 : rc;
}

}  // namespace

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp8-e4m3. Returns cudaGetLastError()
// after the launch, or -1 for a shape/dtype the kernel does not take (the
// Python wrapper checks those first).
extern "C" int nxdi_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* new_k, const void* new_v, const void* lens,
    const void* block_table, const void* sink, void* part_acc,
    void* part_ml, void* counters, void* out, int batch, int layer,
    int num_pages, int block_size, int hkv, int g, int head_dim,
    int max_blocks, int nsplit, int window, float scale, float soft_cap,
    float kv_scale, int kv_dtype, int q_bf16, void* stream) {
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const int32_t* tb = static_cast<const int32_t*>(block_table);
  const float* sk = static_cast<const float*>(sink);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLITS) return -1;
  int rc = -1;
#define NXDI_KV(TKV, DD)                                                    \
  rc = launch<TKV, DD>(q, k_pages, v_pages, new_k, new_v, ln, tb, sk, pacc, \
                       pml, cnt, out, batch, layer, num_pages, block_size,  \
                       hkv, g, max_blocks, nsplit, window, scale, soft_cap, \
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
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
