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
// What the design does about that: ONE launch, grid (splits, Hkv, B). Each
// block takes an equal share of its row's live keys (split-K, at least
// 2048/D keys, so B*Hkv*splits blocks keep the SMs loading at batch 4);
// blocks whose share is empty exit at once (a row with no live key keeps
// one block, for its merge). A block walks its share in tiles of 32 keys:
//   - cp.async copies each tile's K and V rows (16-byte pieces, addresses
//     from the block table) straight into a 3-stage ring in shared memory,
//     in the cache's own dtype (a row's pieces XOR-swizzled by the row
//     index: conflict-free 16-byte and ldmatrix reads with no padding, so 8
//     blocks fit an SM). Two tiles are in flight while one is used, and the
//     stage hand-off is the only block barrier of a tile.
//   - bf16 pages with bf16 queries (the serving path) run the tile math on
//     the tensor cores (paged_decode_mma): the G <= 16 query heads are the
//     rows of mma.sync tiles, warp w takes keys 8w .. 8w + 7 of the tile,
//     S = Q K^T by m16n8k16, fp32 online softmax per head in registers,
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
//     scratch; counters (B * Hkv) int32, zero before and after each launch;
//     all allocated by the caller

#include "decode_common.cuh"

namespace {

constexpr int PT = 32;           // keys per tile
constexpr int PSTAGES = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group have landed (for this thread)
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename TKV, int D>
struct PagedTile {
  static constexpr int ROW = D * (int)sizeof(TKV);       // row bytes
  static constexpr int CPR = ROW / 16;                   // pieces per row
  static constexpr int SWZ = CPR < 8 ? CPR - 1 : 7;      // swizzle mask
  static constexpr int STAGE = 2 * PT * ROW;             // K then V
  static constexpr int BYTES = PSTAGES * STAGE;
  // byte offset of piece c of row t
  static __device__ __forceinline__ int at(int t, int c) {
    return t * ROW + ((c ^ (t & SWZ)) << 4);
  }
};

// What every block of a (row, KV head, split) works out first.
struct Share {
  int lo, hi;        // its live keys [lo, hi)
  int n_part;        // the row's blocks with keys (at least 1)
  int n_tiles;
};

// live keys: kpos < pos strictly and, with a window, pos - kpos < window;
// a block's share is an equal part of them, at least `min_share` keys, so
// a short row leaves its surplus blocks empty; the blocks with keys are
// the first n_part (a row with none keeps block 0, for its merge)
__device__ __forceinline__ Share share_of(int pos, int window, int split,
                                          int nsplit, int min_share) {
  Share sh;
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  const int n_live = max(pos - kstart, 0);
  const int per = max((n_live + nsplit - 1) / nsplit, min_share);
  sh.lo = kstart + split * per;
  sh.hi = min(sh.lo + per, pos);
  sh.n_part = max((n_live + per - 1) / per, 1);
  sh.n_tiles = sh.hi > sh.lo ? (sh.hi - sh.lo + PT - 1) / PT : 0;
  return sh;
}

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
  constexpr int EPV = 16 / sizeof(TKV);
  if (i < sh.n_tiles) {
    char* st = ring + (i % PSTAGES) * L::STAGE;
    const int t0 = sh.lo + i * PT;
    for (int c = threadIdx.x; c < PT * L::CPR; c += NT) {
      const int t = c / L::CPR;
      const int kp = t0 + t;
      const int so = L::at(t, c % L::CPR);
      if (kp < sh.hi) {
        const int64_t off = (int64_t)table[kp / block_size] * page_stride +
                            (int64_t)(kp % block_size) * row_stride +
                            head_off + (c % L::CPR) * EPV;
        cp_async16(st + so, k_pages + off);
        cp_async16(st + PT * L::ROW + so, v_pages + off);
      } else if (ZFILL) {
        cp_async16(st + so, k_pages, false);
        cp_async16(st + PT * L::ROW + so, v_pages, false);
      }
    }
  }
  cp_async_commit();
}

// DPL consecutive fp32 of the scratch, past L1 (written by other blocks)
template <int DPL>
__device__ __forceinline__ void ldcg_cols(float (&r)[DPL], const float* p) {
  static_assert(DPL == 2 || DPL == 4, "D / 32 columns a lane");
  if constexpr (DPL == 2) {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    r[0] = x.x;
    r[1] = x.y;
  } else {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  }
}

// The active token's query, key and value columns for the merge, loaded
// when a block starts (they need no other block, so the loads are in
// flight with its tiles; the dot products wait for the merge): warp w
// holds heads w, w + NW, ...; lane holds columns lane * D/32 ..
template <int D, int GMAX>
struct Active {
  float q[(GMAX + NW - 1) / NW][D / 32];
  float k[D / 32];
  float v[D / 32];
};

template <int D, int GMAX>
__device__ __forceinline__ Active<D, GMAX> active_token(
    const void* q, const void* new_k, const void* new_v, int b, int h,
    int hkv, int g, int q_bf16) {
  constexpr int HPW = (GMAX + NW - 1) / NW;
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t kv_row = ((int64_t)b * hkv + h) * D + lane * DPL;
  Active<D, GMAX> a;
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    a.k[e] = load_act(new_k, kv_row + e, q_bf16);
    a.v[e] = load_act(new_v, kv_row + e, q_bf16);
  }
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = min(warp + j * NW, g - 1);
    const int64_t q_row =
        ((int64_t)b * hkv * g + (int64_t)h * g + gg) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) a.q[j][e] = load_act(q, q_row + e, q_bf16);
  }
  return a;
}

// The fused merge, after a block has written its split's (m, l, acc): the
// block counts itself on its (row, KV head)'s counter (a release atomic
// after a block barrier, as a semaphore: the writes of every thread are
// visible before the count); the last of the n_part blocks (an acquire
// atomic) merges their splits with the active token and the sink (warp w:
// heads w, w + NW, ...; lane: columns lane * D/32 ..; lane s holds splits
// s and s + 32) and puts the counter back to 0.
template <int D, int GMAX>
__device__ __forceinline__ void merge_tail(
    const Active<D, GMAX>& act, const float* sink, const float* part_acc,
    const float* part_ml, int* counters, void* out, int b, int h, int hkv,
    int g, int nsplit, int n_part, float scale, float soft_cap, int q_bf16,
    int* s_last) {
  constexpr int HPW = (GMAX + NW - 1) / NW;
  constexpr int DPL = D / 32;
  constexpr int SB = D == 64 ? 32 : 16;        // splits loaded at a time
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * g;
  __syncthreads();
  int* counter = counters + (int64_t)b * hkv + h;
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    *s_last = prev == n_part - 1;
  }
  __syncthreads();
  if (!*s_last) return;

  const int64_t part0 = ((int64_t)b * hkv + h) * nsplit;
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = warp + j * NW;
    if (gg >= g) break;
    const float* pa0 = part_acc + (part0 * g + gg) * D + lane * DPL;
    float ms[2], ls[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = lane + 32 * k;
      ms[k] = NEG_INF;
      ls[k] = 0.f;
      if (s < n_part) {
        ms[k] = __ldcg(part_ml + ((part0 + s) * g + gg) * 2);
        ls[k] = __ldcg(part_ml + ((part0 + s) * g + gg) * 2 + 1);
      }
    }
    // the first SB splits' accumulators load beside (m, l)
    float a[SB][DPL];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      if (u < n_part) ldcg_cols(a[u], pa0 + (int64_t)u * g * D);
      else
#pragma unroll
        for (int e = 0; e < DPL; ++e) a[u][e] = 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dot += act.q[j][e] * act.k[e];
    const float sa = cap(warp_sum(dot) * scale, soft_cap);
    float mt = fmaxf(sa, warp_max(fmaxf(ms[0], ms[1])));
    float sk = 0.f;
    if (sink != nullptr) {
      sk = sink[h * g + gg];
      mt = fmaxf(mt, sk);
    }
    float den =
        warp_sum(ls[0] * expf(ms[0] - mt) + ls[1] * expf(ms[1] - mt));
    const float ea = expf(sa - mt);
    den += ea;
    if (sink != nullptr) den += expf(sk - mt);
    const float inv = 1.f / den;
    float w[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) w[k] = expf(ms[k] - mt) * inv;
    float o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = ea * inv * act.v[e];
    for (int s0 = 0; s0 < n_part; s0 += SB) {
      if (s0 > 0) {
#pragma unroll
        for (int u = 0; u < SB; ++u) {
          if (s0 + u < n_part) ldcg_cols(a[u], pa0 + (int64_t)(s0 + u) * g * D);
          else
#pragma unroll
            for (int e = 0; e < DPL; ++e) a[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const int s = s0 + u;
        const float ws =
            __shfl_sync(0xffffffffu, s < 32 ? w[0] : w[1], s & 31);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[e] += ws * a[u][e];
      }
    }
    const int64_t oi = ((int64_t)b * hq + (int64_t)h * g + gg) * D +
                       lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      if (q_bf16)
        reinterpret_cast<__nv_bfloat16*>(out)[oi + e] =
            __float2bfloat16(o[e]);
      else
        reinterpret_cast<float*>(out)[oi + e] = o[e];
    }
  }
  if (threadIdx.x == 0) *counter = 0;          // ready for the next launch
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
  constexpr int HPW = (GMAX + NW - 1) / NW;    // heads per warp
  constexpr int DPL = D / 32;                  // output columns per lane
  constexpr int EPV = 16 / sizeof(TKV);        // elements per 16 bytes

  extern __shared__ __align__(16) char ring[];
  __shared__ __align__(16) float sQ[GMAX * D];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Share sh = share_of(lens[b], window, split, nsplit, 2048 / D);
  if (split >= sh.n_part) return;

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const int32_t* table = block_table + (int64_t)b * max_blocks;
  const Active<D, GMAX> act =
      active_token<D, GMAX>(q, new_k, new_v, b, h, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, false>(ring, i, sh, k_pages, v_pages, table,
                              block_size, page_stride, row_stride,
                              head_off);
  };
  issue(0);
  issue(1);

  const int64_t q_off = ((int64_t)b * hkv * g + (int64_t)h * g) * D;
  for (int i = tid; i < GMAX * D; i += NT)
    sQ[i] = i / D < g ? load_act(q, q_off + i, q_bf16) : 0.f;

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
    cp_async_wait_one();
    __syncthreads();      // tile i (and sQ) visible; tile i - 1 consumed
    issue(i + 2);
    const char* st = ring + (i % PSTAGES) * L::STAGE;
    const int nv = min(PT, sh.hi - (sh.lo + i * PT));
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int gg = warp + j * NW;
      if (gg >= g) break;
      // score of key `lane`
      float s = NEG_INF;
      if (lane < nv) {
        const float4* qr = reinterpret_cast<const float4*>(sQ + gg * D);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < L::CPR; ++c) {
          const Vec16<TKV> x =
              *reinterpret_cast<const Vec16<TKV>*>(st + L::at(lane, c));
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
      const float m_new = fmaxf(m[j], warp_max(s));
      const float alpha = expf(m[j] - m_new);
      const float p = expf(s - m_new);         // dead keys: 0
      l[j] = l[j] * alpha + warp_sum(p);
      m[j] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[j][e] *= alpha;
      // acc += p V: lane owns columns lane * DPL .. (piece vc, byte vb)
      const char* vt = st + PT * L::ROW;
      constexpr int LB = DPL * (int)sizeof(TKV);       // bytes per lane
      const int vc = lane * LB / 16;
      const int vb = lane * LB % 16;
#pragma unroll 8
      for (int t = 0; t < nv; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const TKV* vr =
            reinterpret_cast<const TKV*>(vt + L::at(t, vc) + vb);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[j][e] += pt * to_f(vr[e]);
      }
    }
  }

  // this split's (m, l) and acc per head (acc = 0, l = 0 if empty)
  const int64_t part = ((int64_t)b * hkv + h) * nsplit + split;
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = warp + j * NW;
    if (gg >= g) break;
    if (lane == 0) {
      part_ml[(part * g + gg) * 2] = m[j];
      part_ml[(part * g + gg) * 2 + 1] = l[j];
    }
    float* pa = part_acc + (part * g + gg) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) pa[e] = acc[j][e] * kv_scale;
  }
  merge_tail<D, GMAX>(act, sink, part_acc, part_ml, counters, out, b, h,
                      hkv, g, nsplit, sh.n_part, scale, soft_cap, q_bf16,
                      &s_last);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}
// the rounding error of pack_bf16(lo, hi), itself packed
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi,
                                                   uint32_t packed) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(x), hi - __high2float(x));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16 x 8, fp32) += a (16 x 16) b (16 x 8), bf16
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c (16 x 8, fp32) += a (16 x 8) b (8 x 8), bf16
__device__ __forceinline__ void mma_1688(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Tensor cores: bf16 pages and bf16 queries, G <= 16.
template <int D, typename TKV = __nv_bfloat16>
__global__ void __launch_bounds__(NT)
paged_decode_mma(NXDI_PAGED_PARAMS) {
  using L = PagedTile<TKV, D>;
  constexpr int KS = D / 16;                   // k-steps of the scores
  constexpr int NTL = D / 8;                   // 8-column tiles of O

  extern __shared__ __align__(16) char ring[];
  __shared__ float sM[NW][16], sL[NW][16];
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Share sh = share_of(lens[b], window, split, nsplit, 2048 / D);
  if (split >= sh.n_part) return;

  const int64_t row_stride = (int64_t)hkv * D;            // one token
  const int64_t page_stride = (int64_t)block_size * row_stride;
  const int64_t head_off =
      (int64_t)layer * num_pages * page_stride + (int64_t)h * D;
  const int32_t* table = block_table + (int64_t)b * max_blocks;
  const Active<D, MAX_G> act =
      active_token<D, MAX_G>(q, new_k, new_v, b, h, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, true>(ring, i, sh, k_pages, v_pages, table,
                             block_size, page_stride, row_stride, head_off);
  };
  issue(0);
  issue(1);

  // Q as m16n8k16 A fragments: rows = query heads (0 past g)
  const int gr = lane / 4;                     // rows gr and gr + 8
  const int tq = lane % 4;
  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(q) +
                            ((int64_t)b * hkv * g + (int64_t)h * g) * D;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gr + 8 * (r & 1);
      const int col = 16 * kk + 2 * tq + 8 * (r >> 1);
      qa[kk][r] = row < g ? *reinterpret_cast<const uint32_t*>(
                                qh + (int64_t)row * D + col)
                          : 0u;
    }

  float o[NTL][4];
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};                     // this thread's keys' share
  const float ks = scale * kv_scale;
  const int kb = 8 * warp;                     // this warp's keys of a tile

  for (int i = 0; i < sh.n_tiles; ++i) {
    cp_async_wait_one();
    __syncthreads();          // tile i visible; tile i - 1 consumed
    issue(i + 2);
    const char* st = ring + (i % PSTAGES) * L::STAGE;
    const int nv = min(PT, sh.hi - (sh.lo + i * PT));
    if (kb >= nv) continue;   // the warp's keys are all dead
    // S (16 heads x 8 keys): c0, c1 head gr, keys kb + 2 tq + {0, 1};
    // c2, c3 head gr + 8
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k2 = 0; k2 < KS / 2; ++k2) {
      uint32_t r[4];
      ldsm_x4(r, st + L::at(kb + (lane & 7), 4 * k2 + (lane >> 3)));
      mma_16816(c, qa[2 * k2], r[0], r[1]);
      mma_16816(c, qa[2 * k2 + 1], r[2], r[3]);
    }
    float p[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = kb + 2 * tq + (e & 1) < nv ? cap(c[e] * ks, soft_cap) : NEG_INF;
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
    for (int n = 0; n < NTL; ++n) {
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
    const char* vt = st + PT * L::ROW;
#pragma unroll
    for (int n4 = 0; n4 < NTL / 4; ++n4) {
      uint32_t v[4];
      ldsm_x4_t(v, vt + L::at(kb + (lane & 7), 4 * n4 + (lane >> 3)));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_1688(o[4 * n4 + j], h0, h1, v[j]);
        mma_1688(o[4 * n4 + j], l0, l1, v[j]);
      }
    }
  }

  // the four warps' states into the block's split, through shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();                             // the ring is free
  float* sO = reinterpret_cast<float*>(ring);  // [NW][16][D]
  if (tq == 0) {
    sM[warp][gr] = m[0];
    sM[warp][gr + 8] = m[1];
    sL[warp][gr] = l[0];
    sL[warp][gr + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < NTL; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sO[(warp * 16 + gr + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] =
          o[n][e];
  __syncthreads();
  const int64_t part = ((int64_t)b * hkv + h) * nsplit + split;
  for (int idx = tid; idx < g * D; idx += NT) {
    const int gg = idx / D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sM[w][gg]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a += sO[(w * 16 + gg) * D + idx % D] * expf(sM[w][gg] - mm);
    part_acc[part * g * D + idx] = a * kv_scale;
  }
  if (tid < g) {
    float mm = NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sM[w][tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w) ll += sL[w][tid] * expf(sM[w][tid] - mm);
    part_ml[(part * g + tid) * 2] = mm;
    part_ml[(part * g + tid) * 2 + 1] = ll;
  }
  merge_tail<D, MAX_G>(act, sink, part_acc, part_ml, counters, out, b, h,
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
  const dim3 grid(nsplit, hkv, batch);
  int rc = 0;
  // the kernel, its dynamic shared memory opted in once per instantiation
  // (before any CUDA-graph capture of a launch), then the launch
  auto go = [&](auto* kern, bool& opted_in) {
    if (!opted_in) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) {
        rc = static_cast<int>(e);
        return;
      }
      opted_in = true;
    }
    kern<<<grid, NT, bytes, stream>>>(
        q, static_cast<const TKV*>(kp), static_cast<const TKV*>(vp), nk, nv,
        lens, table, sink, pacc, pml, counters, out, layer, num_pages,
        block_size, hkv, g, max_blocks, window, scale, soft_cap, kv_scale,
        q_bf16);
  };
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    if (q_bf16 && g <= MAX_G) {
      static bool opted_in = false;
      go(paged_decode_mma<D>, opted_in);
      return rc;
    }
  }
  const int ok = for_group(g, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    static bool opted_in = false;
    go(paged_decode_simt<TKV, D, GM>, opted_in);
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
