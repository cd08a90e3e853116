// Contiguous-cache one-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/decode_attention.py::_decode_kernel of the JAX
// package (neuronx_distributed_inference_tpu/ops/decode_attention.py:41-128,
// wrapper decode_attention_stacked :162-261): one query token per row; each
// KV head's GQA group of G = Hq/Hkv query heads attends over the row's prior
// keys [max(0, pos - w + 1), pos) of layer `layer` of the stacked cache (w =
// 0: no window), plus the active token (new_k/new_v, folded in from
// registers, never read from the cache). fp32 online softmax; options:
// dynamic sliding window, tanh soft-cap, per-head sink that enters the
// denominator only, kv_scale dequantisation on load.
//
// What bounds it on the H100: the bytes of the live K/V. Each key and value
// row is used once per KV head, for G query heads: about 2*G flops per byte
// loaded, far below the ~295 flop/byte the card needs before compute matters,
// so it is HBM-bound: sum_b live keys x Hkv x D x 2 x element size, at
// 3.35 TB/s (~14 MB, 4.2 us, at the Mistral-7B path's batch-4 decode). At
// that size the latencies count as much: the launch, lens -> K/V loads,
// the tile math's instructions, barriers and the merge of the splits.
// What the design does about that: the paged kernel's design
// (decode_common.cuh), with contiguous addressing. ONE launch, grid
// (splits, Hkv x C, B), C = ceil(G / 16) chunks of at most 16 query heads a
// KV head: each block takes an equal share of its row's live keys,
// at least one tile and a multiple of a 16-byte piece's keys; blocks whose
// share is empty exit at once; the last block of a (row, KV head) with keys
// merges the splits (the fused merge), so no combine kernel and no memset
// are launched. A block walks its share in tiles:
//   - cp.async copies each tile into a 3-stage ring in the cache's own
//     dtype: K as D rows of the tile's S-contiguous keys (the cache stores
//     K transposed, (D, S) per head), V as one row of D per key, each cut in
//     16-byte pieces XOR-swizzled by row (K by d, V by key: SwzRows), so
//     ldmatrix reads hit no bank conflict without padding. A thread copies
//     fixed piece columns, so its addresses are worked out once a tile.
//     Pieces with no live key are not read; for the tensor cores dead V
//     rows are zero-filled (src-size 0). Two tiles are in flight while one
//     is used; the stage hand-off is the tile's only block barrier.
//   - bf16 cache with bf16 queries (the Mistral-7B serving path), S a
//     multiple of 8: tensor cores (decode_mma), tiles of 64 keys (a K^T row
//     of the tile is one 128-byte line). A chunk's <= 16 query heads are
//     the 16 rows of mma.sync tiles; warp w takes keys 16w .. 16w + 15.
//     S = Q K^T by m16n8k16 with K's fragments from a .trans ldmatrix (the
//     tile holds K^T: rows are d), dead keys' scores overwritten with
//     NEG_INF (a 16-byte K piece that straddles the window start or lens
//     holds dead keys), O += P V by m16n8k16 (V by a .trans ldmatrix; the
//     two 8-key score blocks are P's A fragment) with P = bf16(p) +
//     bf16(p - bf16(p)) (two products: the probabilities keep ~16 bits).
//   - fp32 or fp8 caches, fp32 queries: CUDA cores (decode_simt), tiles of
//     32 keys, the same ring and merge: a warp owns query heads, lane t
//     scores key t of the tile (reading K column t, d by d), then owns D/32
//     output columns of P V. A cache whose S is not a multiple of a 16-byte
//     piece's keys cannot be read in pieces: it takes decode_simt with the
//     K tile loaded key by key (plain loads; V rows stay 16-byte pieces).
//   The route is fixed by dtype and shape; every route is this file's.
//
// Layouts (all contiguous):
//   q (B, Hq, D) and out (B, Hq, D): fp32 or bf16 (q_bf16 flag)
//   new_k/new_v (B, Hkv, D): same dtype as q
//   k_cache (L, B, Hkv, D, S) transposed, v_cache (L, B, Hkv, S, D): fp32,
//     bf16 or fp8-e4m3 (template TKV)
//   lens (B,) int32 prior lengths, each at most S; sink (Hq,) fp32 or null
//   part_acc (B, Hkv, splits, G, D) and part_ml (B, Hkv, splits, G, 2) fp32
//     scratch; counters (B * Hkv * C) int32, zero before and after each launch
//     (the paged kernel's buffer: both run on one stream and leave it 0);
//     all allocated by the caller

#include "decode_common.cuh"

namespace {

constexpr int CSTAGES = 3;       // ring stages

// a stage of the ring: K^T (D rows of TK keys), then V (TK rows of D)
template <typename TKV, int D, int TK>
struct ContigTile {
  using KRows = SwzRows<TK * (int)sizeof(TKV)>;
  using VRows = SwzRows<D * (int)sizeof(TKV)>;
  static constexpr int KBYTES = D * KRows::ROW_BYTES;
  static constexpr int STAGE = KBYTES + TK * VRows::ROW_BYTES;
  static constexpr int BYTES = CSTAGES * STAGE;
};

// Tile i of the share (keys t0 + i TK ..) into stage i % CSTAGES, then one
// commit (an empty group past the last tile keeps the count). K: the
// 16-byte pieces that hold a live key, by cp.async (vec), or each live key
// by a plain load (!vec: S is not a multiple of a piece's keys). V: the
// live rows by cp.async; ZFILL: dead rows zero-filled. A thread copies
// fixed piece columns of rows tid / pieces-per-row + j NT / pieces-per-row,
// so its addresses are worked out once per tile.
template <typename TKV, int D, int TK, bool ZFILL>
__device__ __forceinline__ void issue_tile(char* ring, int i,
                                           const Share& sh,
                                           const TKV* kbase,
                                           const TKV* vbase, int seq,
                                           bool vec) {
  using L = ContigTile<TKV, D, TK>;
  using KR = typename L::KRows;
  using VR = typename L::VRows;
  constexpr int EPV = 16 / sizeof(TKV);
  constexpr int KSTEP = NT / KR::CPR;          // K rows a pass covers
  constexpr int VSTEP = NT / VR::CPR;          // V rows a pass covers
  static_assert(NT % KR::CPR == 0 && D % KSTEP == 0, "K tile shape");
  static_assert(NT % VR::CPR == 0 && TK % VSTEP == 0, "V tile shape");
  if (i < sh.n_tiles) {
    char* st = ring + (i % CSTAGES) * L::STAGE;
    const int t0 = sh.t0 + i * TK;
    if (vec) {
      const int kc = threadIdx.x % KR::CPR;
      const int d0 = threadIdx.x / KR::CPR;
      const int k0 = t0 + kc * EPV;
      if (k0 < sh.hi && k0 + EPV > sh.lo) {    // the piece holds a live key
        const TKV* src = kbase + (int64_t)d0 * seq + k0;
#pragma unroll
        for (int j = 0; j < D / KSTEP; ++j)
          cp_async16(st + KR::template at_step<KSTEP>(d0, kc, j),
                     src + (int64_t)j * KSTEP * seq);
      }
    } else {
      for (int c = threadIdx.x; c < D * TK; c += NT) {
        const int d = c / TK;
        const int t = c % TK;
        if (t0 + t >= sh.lo && t0 + t < sh.hi)
          reinterpret_cast<TKV*>(st + KR::at(d, t / EPV))[t % EPV] =
              kbase[(int64_t)d * seq + t0 + t];
      }
    }
    char* vt = st + L::KBYTES;
    const int vc = threadIdx.x % VR::CPR;
    const int r0 = threadIdx.x / VR::CPR;
    const TKV* vsrc = vbase + (int64_t)(t0 + r0) * D + vc * EPV;
#pragma unroll
    for (int j = 0; j < TK / VSTEP; ++j) {
      const int kp = t0 + r0 + j * VSTEP;
      char* dst = vt + VR::template at_step<VSTEP>(r0, vc, j);
      if (kp >= sh.lo && kp < sh.hi)
        cp_async16(dst, vsrc + j * VSTEP * D);
      else if (ZFILL)
        cp_async16(dst, vbase, false);
    }
  }
  cp_async_commit();
}

#define NXDI_CONTIG_PARAMS                                                 \
  const void *__restrict__ q, const TKV *__restrict__ k_cache,             \
      const TKV *__restrict__ v_cache, const void *__restrict__ new_k,     \
      const void *__restrict__ new_v, const int32_t *__restrict__ lens,    \
      const float *__restrict__ sink, float *__restrict__ part_acc,        \
      float *__restrict__ part_ml, int *__restrict__ counters,             \
      void *__restrict__ out, int layer, int batch, int hkv, int g,        \
      int seq, int window, float scale, float soft_cap, float kv_scale,    \
      int q_bf16

// CUDA cores: fp32 or fp8 caches, fp32 queries, or S not a multiple of a
// 16-byte piece's keys (vec = 0).
template <typename TKV, int D, int GMAX>
__global__ void __launch_bounds__(NT)
decode_simt(NXDI_CONTIG_PARAMS, int vec) {
  using L = ContigTile<TKV, D, PT>;
  using KR = typename L::KRows;
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
  const Share sh =
      share_of<PT>(lens[b], window, split, nsplit, PT, vec ? EPV : 1);
  if (split >= sh.n_part) return;

  const int64_t head = ((int64_t)layer * batch + b) * hkv + h;
  const TKV* kbase = k_cache + head * D * seq;     // (D, S) of this head
  const TKV* vbase = v_cache + head * seq * D;     // (S, D) of this head
  const Active<D, GMAX> act =
      active_token<D, GMAX>(q, new_k, new_v, b, ck, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, PT, false>(ring, i, sh, kbase, vbase, seq, vec);
  };
  for (int i = 0; i < CSTAGES - 1; ++i) issue(i);

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
    cp_async_wait<CSTAGES - 2>();
    __syncthreads();      // tile i (and sQ) visible; tile i - 1 consumed
    issue(i + CSTAGES - 1);
    const char* st = ring + (i % CSTAGES) * L::STAGE;
    const int ts = sh.t0 + i * PT;
    const int tlo = max(sh.lo - ts, 0);
    const int thi = min(sh.hi - ts, PT);
    const bool live = lane >= tlo && lane < thi;
    // scores of key `lane` for the warp's heads: column `lane` of K^T
    float dot[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) dot[j] = 0.f;
    if (live) {
      const int kc = lane / EPV;
      const int ke = lane % EPV;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd =
            to_f(reinterpret_cast<const TKV*>(st + KR::at(d, kc))[ke]);
#pragma unroll
        for (int j = 0; j < HPW; ++j)
          if (warp + j * NW < GMAX)
            dot[j] += sQ[(warp + j * NW) * D + d] * kd;
      }
    }
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      if (warp + j * NW >= ck.gc) break;
      const float s = live ? cap(dot[j] * ks, soft_cap) : NEG_INF;
      simt_update<TKV, D>(s, m[j], l[j], acc[j], st + L::KBYTES, tlo, thi);
    }
  }

  simt_write_split<D, HPW>(m, l, acc, part_acc, part_ml,
                           ((int64_t)b * hkv + h) * nsplit + split, g, ck,
                           kv_scale);
  merge_tail<D, GMAX>(act, sink, part_acc, part_ml, counters, out, b, ck,
                      hkv, g, nsplit, sh.n_part, scale, soft_cap, q_bf16,
                      &s_last);
}

// One warp's 16 keys kb .. kb + 15 of a tile on the tensor cores, after
// S = Q K^T: c[n] holds keys kb + 8 n + 2 (lane % 4) + {0, 1} of heads
// lane / 4 (c0, c1) and lane / 4 + 8 (c2, c3). Keys outside [tlo, thi) are
// overwritten with NEG_INF (select, not add: a dead key's score may be
// anything, NaN included); the per-head online softmax (m, l) of this
// thread's keys moves on; O += P V by m16n8k16 with P = bf16(p) + bf16(p -
// bf16(p)) (two products: the probabilities keep ~16 bits); the score
// layout of the two key blocks is P's A fragment. V: the tile's rows of D
// bf16 at vt (SwzRows<2 D>), dead rows zero (mma multiplies them by 0).
template <int D>
__device__ __forceinline__ void mma_update16(float (&c)[2][4], int kb,
                                             int tlo, int thi, float ks,
                                             float soft_cap, float (&m)[2],
                                             float (&l)[2],
                                             float (&o)[D / 8][4],
                                             const char* vt) {
  using VR = SwzRows<2 * D>;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = kb + 8 * n + 2 * tq + (e & 1);
      c[n][e] = t >= tlo && t < thi ? cap(c[n][e] * ks, soft_cap) : NEG_INF;
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(c[0][2 * r], c[0][2 * r + 1]),
                     fmaxf(c[1][2 * r], c[1][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        c[n][e] = expf(c[n][e] - m_new);       // dead keys: 0
        sum += c[n][e];
      }
    l[r] = l[r] * alpha[r] + sum;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  uint32_t ph[4], pl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {                // (head row, key block)
    const int n = j >> 1, e = 2 * (j & 1);
    ph[j] = pack_bf16(c[n][e], c[n][e + 1]);
    pl[j] = pack_bf16_rest(c[n][e], c[n][e + 1], ph[j]);
  }
  // matrices: keys kb .. +7 / kb + 8 .. +15 of d-columns 16 n2 .. +7, then
  // the same of d-columns 16 n2 + 8 .. +15
  const int vrow = kb + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t v[4];
    ldsm_x4_t(v, vt + VR::at(vrow, 2 * n2 + (lane >> 4)));
    mma_16816(o[2 * n2], ph, v[0], v[1]);
    mma_16816(o[2 * n2], pl, v[0], v[1]);
    mma_16816(o[2 * n2 + 1], ph, v[2], v[3]);
    mma_16816(o[2 * n2 + 1], pl, v[2], v[3]);
  }
}

// Tensor cores: bf16 cache and bf16 queries, S % 8 == 0. Tiles of
// MK = 64 keys: a K^T row of the tile is one 128-byte line; warp w takes
// keys 16 w .. 16 w + 15.
constexpr int MK = 64;

template <int D, typename TKV = __nv_bfloat16>
__global__ void __launch_bounds__(NT)
decode_mma(NXDI_CONTIG_PARAMS) {
  using L = ContigTile<TKV, D, MK>;
  using KR = typename L::KRows;
  constexpr int KS = D / 16;                   // k-steps of the scores
  constexpr int EPV = 8;                       // keys of a K piece
  static_assert(KR::CPR == MK / EPV && MK / 16 == NW, "warp w: 2 pieces");
  static_assert(L::BYTES >= NW * 16 * D * 4, "mma_write_split's sO");

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
  const Share sh =
      share_of<MK>(lens[b], window, split, nsplit, MK, EPV);
  if (split >= sh.n_part) return;

  const int64_t head = ((int64_t)layer * batch + b) * hkv + h;
  const TKV* kbase = k_cache + head * D * seq;     // (D, S) of this head
  const TKV* vbase = v_cache + head * seq * D;     // (S, D) of this head
  const Active<D, MAX_G> act =
      active_token<D, MAX_G>(q, new_k, new_v, b, ck, hkv, g, q_bf16);
  auto issue = [&](int i) {
    issue_tile<TKV, D, MK, true>(ring, i, sh, kbase, vbase, seq, true);
  };
  for (int i = 0; i < CSTAGES - 1; ++i) issue(i);

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
  const int kb = 16 * warp;                    // this warp's keys of a tile
  // ldmatrix rows of K^T: d = 16 kk + (lane & 15), pieces 2 w + (lane >> 4)
  const int krow = lane & 15;
  const int kpiece = 2 * warp + (lane >> 4);

  for (int i = 0; i < sh.n_tiles; ++i) {
    cp_async_wait<CSTAGES - 2>();
    __syncthreads();          // tile i visible; tile i - 1 consumed
    issue(i + CSTAGES - 1);
    const char* st = ring + (i % CSTAGES) * L::STAGE;
    const int ts = sh.t0 + i * MK;
    const int tlo = max(sh.lo - ts, 0);
    const int thi = min(sh.hi - ts, MK);
    if (kb >= thi || kb + 16 <= tlo) continue;  // the warp's keys are dead
    // S (16 heads x 16 keys) = Q K^T: the tile holds K^T (rows d), so a
    // .trans ldmatrix gives the B fragments (matrices: d 16 kk .. +7 and
    // +8 .. +15 of the warp's two pieces); even and odd k-steps sum apart
    // (shorter dependent chains)
    float c[2][4] = {}, c2[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t r[4];
      ldsm_x4_t(r, st + KR::at(16 * kk + krow, kpiece));
      if (kk & 1) {
        mma_16816(c2[0], qa[kk], r[0], r[1]);
        mma_16816(c2[1], qa[kk], r[2], r[3]);
      } else {
        mma_16816(c[0], qa[kk], r[0], r[1]);
        mma_16816(c[1], qa[kk], r[2], r[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += c2[n][e];
    mma_update16<D>(c, kb, tlo, thi, ks, soft_cap, m, l, o, st + L::KBYTES);
  }

  mma_write_split<D>(m, l, o, ring, sM, sL, part_acc, part_ml,
                     ((int64_t)b * hkv + h) * nsplit + split, g, ck, kv_scale);
  merge_tail<D, MAX_G>(act, sink, part_acc, part_ml, counters, out, b, ck,
                       hkv, g, nsplit, sh.n_part, scale, soft_cap, q_bf16,
                       &s_last);
}

#undef NXDI_CONTIG_PARAMS

template <typename TKV, int D>
int launch(const void* q, const void* kc, const void* vc, const void* nk,
           const void* nv, const int32_t* lens, const float* sink,
           float* pacc, float* pml, int* counters, void* out, int batch,
           int layer, int hkv, int g, int seq, int nsplit, int window,
           float scale, float soft_cap, float kv_scale, int q_bf16,
           cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(TKV);
  const int vec = seq % EPV == 0;        // every K row 16-byte aligned
  const int nc = (g + MAX_G - 1) / MAX_G;  // chunks of the group
  const dim3 grid(nsplit, hkv * nc, batch);
  const TKV* k = static_cast<const TKV*>(kc);
  const TKV* v = static_cast<const TKV*>(vc);
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    if (q_bf16 && vec) {
      static bool opted_in = false;
      return launch_opted_in(decode_mma<D>, opted_in, grid,
                             ContigTile<TKV, D, MK>::BYTES, stream,
                             q, k, v, nk, nv, lens, sink, pacc, pml,
                             counters, out, layer, batch, hkv, g, seq,
                             window, scale, soft_cap, kv_scale, q_bf16);
    }
  }
  int rc = 0;
  const int ok = for_group(g, [&](auto gm) {
    constexpr int GM = decltype(gm)::value;
    static bool opted_in = false;
    rc = launch_opted_in(decode_simt<TKV, D, GM>, opted_in, grid,
                         ContigTile<TKV, D, PT>::BYTES, stream, q, k, v, nk, nv, lens, sink, pacc, pml,
                         counters, out, layer, batch, hkv, g, seq, window,
                         scale, soft_cap, kv_scale, q_bf16, vec);
  });
  return ok != 0 ? -1 : rc;
}

}  // namespace

// kv_dtype: 0 = fp32, 1 = bf16, 2 = fp8-e4m3. `batch` is the cache's batch
// (the query batch must equal it). Returns cudaGetLastError() after the
// launch, or -1 for a shape/dtype the kernel does not take (the Python
// wrapper checks those first).
extern "C" int nxdi_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* new_k, const void* new_v, const void* lens, const void* sink,
    void* part_acc, void* part_ml, void* counters, void* out, int batch,
    int layer, int hkv, int g, int head_dim, int seq, int nsplit,
    int window, float scale, float soft_cap, float kv_scale, int kv_dtype,
    int q_bf16, void* stream) {
  const int32_t* ln = static_cast<const int32_t*>(lens);
  const float* sk = static_cast<const float*>(sink);
  float* pacc = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLITS) return -1;
  int rc = -1;
#define NXDI_KV(TKV, DD)                                                   \
  rc = launch<TKV, DD>(q, k_cache, v_cache, new_k, new_v, ln, sk, pacc,    \
                       pml, cnt, out, batch, layer, hkv, g, seq, nsplit,   \
                       window, scale, soft_cap, kv_scale, q_bf16, st)
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
