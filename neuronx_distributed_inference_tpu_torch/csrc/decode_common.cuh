// What the two one-token decode kernels share: the paged kernel
// (paged_decode_attention.cu) and the contiguous kernel
// (decode_attention.cu) have one design and differ in how a tile's K and V
// rows are addressed and laid out in shared memory, and in the tile size
// of their tensor-core path.
//
// The design: one launch, grid (splits, Hkv x C, B). A block owns one (row,
// KV head, chunk, split): a KV head's group of G = Hq/Hkv query heads is cut
// in C = ceil(G / MAX_G) chunks of at most MAX_G heads (chunk_of), and a
// chunk's heads share every key its block loads (a wider group's chunks
// each load the KV head's keys; past the first, from L2). Each
// block takes an equal share of its row's live keys (share_of); a block
// whose share is empty exits at once. It walks its share in tiles, copied
// with cp.async into a ring in the cache's own dtype (16-byte pieces,
// XOR-swizzled by row: SwzRows), two tiles in flight while one is used, one
// block barrier a tile. The tile math runs on the tensor cores for bf16
// caches with bf16 queries (load_q_frags, each kernel's tile update,
// mma_write_split) and on the CUDA cores otherwise (simt_update,
// simt_write_split). The combine is fused (merge_tail): a block writes its
// split's (m, l, acc) and counts itself on its (row, KV head, chunk)'s
// counter;
// the last block with keys merges the splits with the active token and the
// sink and resets the counter to 0.
//
// Here: dtype conversion, 16-byte vectors, warp reductions, the soft-cap,
// the cp.async / ldmatrix / mma.sync wrappers, the swizzled row layout,
// the share rule, the CUDA-core tile update, the split write-outs, the
// fused merge and the launch helpers.

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
constexpr int PT = 32;   // keys a tile (paged; contiguous CUDA cores)

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

// ---------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

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
// all but the newest N groups have landed (for this thread)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---------------------------------------------------------------------------
// Tile layout and shares
// ---------------------------------------------------------------------------

// Rows of ROW bytes in shared memory, cut in 16-byte pieces. Piece c of
// row r sits at piece c ^ swz(r) of the row: any 8 consecutive rows' piece
// c then fall in 8 distinct 16-byte bank groups (conflict-free ldmatrix
// and 16-byte reads with no padding). A 128-byte bank line holds RPL rows.
template <int ROW>
struct SwzRows {
  static_assert(ROW % 16 == 0, "rows of 16-byte pieces");
  static constexpr int ROW_BYTES = ROW;
  static constexpr int CPR = ROW / 16;                   // pieces per row
  static constexpr int RPL = ROW < 128 ? 128 / ROW : 1;  // rows per line
  static constexpr int MASK = (CPR < 8 ? CPR : 8) - 1;
  // byte offset of piece c of row r
  static __device__ __forceinline__ int at(int r, int c) {
    return r * ROW + ((c ^ ((r / RPL) & MASK)) << 4);
  }
  // at(r0 + j STEP, c) for r0 >= 0: a step of whole swizzle periods only
  // moves the row
  template <int STEP>
  static __device__ __forceinline__ int at_step(int r0, int c, int j) {
    if constexpr (STEP % (RPL * (MASK + 1)) == 0)
      return at(r0, c) + j * STEP * ROW;
    else
      return at(r0 + j * STEP, c);
  }
};

// The query heads a block serves: grid axis y is KV head x chunk; chunk c
// of KV head h holds the group's heads [g0, g0 + gc), g0 = c MAX_G, gc =
// min(MAX_G, g - g0); a group of at most MAX_G is one chunk (g0 0, gc g).
struct Chunk {
  int h;      // the KV head
  int g0;     // the chunk's first head in the group
  int gc;     // its heads, 1 .. MAX_G
  int slot;   // its merge counter: (row b, KV head, chunk) = b Hkv C + y
};

__device__ __forceinline__ Chunk chunk_of(int g) {
  const int nc = (g + MAX_G - 1) / MAX_G;
  Chunk ck;
  ck.h = blockIdx.y / nc;
  ck.g0 = (blockIdx.y % nc) * MAX_G;
  ck.gc = min(MAX_G, g - ck.g0);
  ck.slot = blockIdx.z * gridDim.y + blockIdx.y;
  return ck;
}

// What every block of a (row, KV head, chunk, split) works out first.
struct Share {
  int lo, hi;        // its live keys [lo, hi)
  int t0;            // the first key of its first tile (t0 <= lo)
  int n_part;        // the row's blocks with keys (at least 1)
  int n_tiles;
};

// Live keys: kpos < pos strictly (the active token is not read from the
// cache) and, with a window, pos - kpos < window. The keys from `base`
// (the first live key rounded down to a multiple of `align`) to pos are
// cut in equal shares of at least `min_share` keys, each a multiple of
// `align` (so a tile's K pieces start aligned); a short row leaves its
// surplus blocks empty. The blocks with keys are the first n_part (a row
// with none keeps block 0, for its merge). Tiles of TK keys.
template <int TK = PT>
__device__ __forceinline__ Share share_of(int pos, int window, int split,
                                          int nsplit, int min_share,
                                          int align) {
  Share sh;
  const int kstart = window > 0 ? max(pos - window + 1, 0) : 0;
  const int base = kstart - kstart % align;
  const int n = max(pos - base, 0);
  int per = max((n + nsplit - 1) / nsplit, min_share);
  per = (per + align - 1) / align * align;
  sh.t0 = base + split * per;
  sh.lo = max(sh.t0, kstart);
  sh.hi = min(sh.t0 + per, pos);
  sh.n_part = max((n + per - 1) / per, 1);
  sh.n_tiles = sh.hi > sh.lo ? (sh.hi - sh.t0 + TK - 1) / TK : 0;
  return sh;
}

// ---------------------------------------------------------------------------
// Tile math
// ---------------------------------------------------------------------------

// Q as m16n8k16 A fragments: rows = query heads (0 past g); lane holds rows
// lane / 4 and lane / 4 + 8
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* qh,
                                             int g) {
  const int gr = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gr + 8 * (r & 1);
      const int col = 16 * kk + 2 * tq + 8 * (r >> 1);
      qa[kk][r] = row < g ? *reinterpret_cast<const uint32_t*>(
                                qh + (int64_t)row * D + col)
                          : 0u;
    }
}

// The four warps' (m, l, O) of the chunk's heads [g0, g0 + gc) into the
// block's split `part` of the scratch (acc times kv_scale; heads of the
// group of g), through shared memory: `ring` (the ring, free once the
// caller's loop is done) must hold NW x 16 x D floats.
template <int D>
__device__ __forceinline__ void mma_write_split(
    float (&m)[2], float (&l)[2], const float (&o)[D / 8][4], char* ring,
    float (&sM)[NW][16], float (&sL)[NW][16], float* part_acc,
    float* part_ml, int64_t part, int g, const Chunk& ck, float kv_scale) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gr = lane / 4;
  const int tq = lane % 4;
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
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sO[(warp * 16 + gr + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] =
          o[n][e];
  __syncthreads();
  for (int idx = tid; idx < ck.gc * D; idx += NT) {
    const int gg = idx / D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sM[w][gg]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a += sO[(w * 16 + gg) * D + idx % D] * expf(sM[w][gg] - mm);
    part_acc[(part * g + ck.g0) * D + idx] = a * kv_scale;
  }
  if (tid < ck.gc) {
    float mm = NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sM[w][tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w) ll += sL[w][tid] * expf(sM[w][tid] - mm);
    part_ml[(part * g + ck.g0 + tid) * 2] = mm;
    part_ml[(part * g + ck.g0 + tid) * 2 + 1] = ll;
  }
}

// One query head of a warp, on the CUDA cores: `s` is the score of the
// tile's key `lane` (NEG_INF when dead), the head's online softmax (m, l)
// moves on and acc += p V over the tile's live keys [tlo, thi), lane owning
// output columns lane * D/32 ..; V: PT rows of D TKV at vt, laid out as
// SwzRows<D * sizeof(TKV)>.
template <typename TKV, int D>
__device__ __forceinline__ void simt_update(float s, float& m, float& l,
                                            float (&acc)[D / 32],
                                            const char* vt, int tlo,
                                            int thi) {
  using VT = SwzRows<D * (int)sizeof(TKV)>;
  constexpr int DPL = D / 32;
  const int lane = threadIdx.x % 32;
  const float m_new = fmaxf(m, warp_max(s));
  const float alpha = expf(m - m_new);
  const float p = expf(s - m_new);             // dead keys: 0
  l = l * alpha + warp_sum(p);
  m = m_new;
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
  constexpr int LB = DPL * (int)sizeof(TKV);   // bytes per lane
  const int vc = lane * LB / 16;               // its piece, byte
  const int vb = lane * LB % 16;
#pragma unroll 8
  for (int t = tlo; t < thi; ++t) {
    const float pt = __shfl_sync(0xffffffffu, p, t);
    const TKV* vr = reinterpret_cast<const TKV*>(vt + VT::at(t, vc) + vb);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] += pt * to_f(vr[e]);
  }
}

// The split's (m, l) and acc (times kv_scale) of each head a warp owns
// (the chunk's heads warp, warp + NW, ...; acc = 0, l = 0 for an empty
// share).
template <int D, int HPW>
__device__ __forceinline__ void simt_write_split(
    const float (&m)[HPW], const float (&l)[HPW],
    const float (&acc)[HPW][D / 32], float* part_acc, float* part_ml,
    int64_t part, int g, const Chunk& ck, float kv_scale) {
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = warp + j * NW;
    if (gg >= ck.gc) break;
    const int64_t row = part * g + ck.g0 + gg;
    if (lane == 0) {
      part_ml[row * 2] = m[j];
      part_ml[row * 2 + 1] = l[j];
    }
    float* pa = part_acc + row * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) pa[e] = acc[j][e] * kv_scale;
  }
}

// ---------------------------------------------------------------------------
// The fused merge
// ---------------------------------------------------------------------------

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
    const void* q, const void* new_k, const void* new_v, int b,
    const Chunk& ck, int hkv, int g, int q_bf16) {
  constexpr int HPW = (GMAX + NW - 1) / NW;
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t kv_row = ((int64_t)b * hkv + ck.h) * D + lane * DPL;
  Active<D, GMAX> a;
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    a.k[e] = load_act(new_k, kv_row + e, q_bf16);
    a.v[e] = load_act(new_v, kv_row + e, q_bf16);
  }
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = min(warp + j * NW, ck.gc - 1);
    const int64_t q_row =
        ((int64_t)b * hkv * g + (int64_t)ck.h * g + ck.g0 + gg) * D +
        lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) a.q[j][e] = load_act(q, q_row + e, q_bf16);
  }
  return a;
}

// The fused merge, after a block has written its split's (m, l, acc): the
// block counts itself on its (row, KV head, chunk)'s counter (a release
// atomic after a block barrier, as a semaphore: the writes of every thread
// are visible before the count); the last of the n_part blocks (an acquire
// atomic) merges their splits with the active token and the sink (warp w:
// the chunk's heads w, w + NW, ...; lane: columns lane * D/32 ..; lane s
// holds splits s and s + 32), stores the output in q's dtype and puts the
// counter back to 0 for the next launch (so CUDA-graph replays see 0).
template <int D, int GMAX>
__device__ __forceinline__ void merge_tail(
    const Active<D, GMAX>& act, const float* sink, const float* part_acc,
    const float* part_ml, int* counters, void* out, int b, const Chunk& ck,
    int hkv, int g, int nsplit, int n_part, float scale, float soft_cap,
    int q_bf16, int* s_last) {
  constexpr int HPW = (GMAX + NW - 1) / NW;
  constexpr int DPL = D / 32;
  constexpr int SB = D == 64 ? 32 : 16;        // splits loaded at a time
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * g;
  __syncthreads();
  int* counter = counters + ck.slot;
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

  const int64_t part0 = ((int64_t)b * hkv + ck.h) * nsplit;
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    const int gg = ck.g0 + warp + j * NW;     // the head in the group
    if (gg >= ck.g0 + ck.gc) break;
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
      sk = sink[ck.h * g + gg];
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
    const int64_t oi = ((int64_t)b * hq + (int64_t)ck.h * g + gg) * D +
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

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

// Calls launch(std::integral_constant<int, GMAX>) for the smallest of the
// CUDA-core kernel's instantiations GMAX >= the widest chunk of a group of
// g (min(g, MAX_G): one launch serves every chunk, a narrower last chunk
// included); -1 when g < 1.
template <typename F>
int for_group(int g, F&& launch) {
  if (g < 1) return -1;
  g = min(g, MAX_G);
  if (g <= 1) launch(std::integral_constant<int, 1>{});
  else if (g <= 2) launch(std::integral_constant<int, 2>{});
  else if (g <= 4) launch(std::integral_constant<int, 4>{});
  else if (g <= 8) launch(std::integral_constant<int, 8>{});
  else if (g <= MAX_G) launch(std::integral_constant<int, MAX_G>{});
  else return -1;
  return 0;
}

// Launches kern<<<grid, NT, bytes, stream>>>(args...), its dynamic shared
// memory opted in once per instantiation (`opted_in`, a static of the
// caller's; the first launch comes before any CUDA-graph capture, whose
// warm-up calls launch eagerly). Returns 0 or the opt-in's cudaError.
template <typename K, typename... A>
int launch_opted_in(K* kern, bool& opted_in, dim3 grid, int bytes,
                    cudaStream_t stream, A... args) {
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  kern<<<grid, NT, bytes, stream>>>(args...);
  return 0;
}

}  // namespace
