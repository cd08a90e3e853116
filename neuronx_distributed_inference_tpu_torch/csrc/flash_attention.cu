// Causal flash attention for contiguous prefill, for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/flash_attention.py::_flash_kernel of the JAX
// package (neuronx_distributed_inference_tpu/ops/flash_attention.py:28-149,
// wrapper flash_attention): q (B, S, Hq, D) attends causally over k/v
// (B, S, Hkv, D), query head h reading KV head h / (Hq/Hkv); optional static
// sliding window (attend iff qpos - kpos < window) and tanh soft-cap; fp32
// scores, online softmax and accumulators; output in q's dtype.
//
// What bounds it on the H100: tensor-core operations. The work is
// 4 * B * Hq * D * sum_q (keys attended) flops (QK^T and PV), at 989 TFLOP/s
// in bf16; each K/V row is reused by every query of a tile, so the bytes
// (q, k, v read once, out written once, at 3.35 TB/s) bound it only for
// short rows.
//
// Two hand-written kernels, chosen by the input dtype:
//
// bf16: flash_tc, warp-specialised on the tensor cores, with a persistent
//   grid: one block per SM walks work items of 128 queries of one (row, q
//   head), longest first, and has three warpgroups.
//   - The producer warpgroup (one thread of it) issues TMA loads: each
//     item's Q tile (two buffers, so the next item's Q loads while the
//     current one is used), then each 128-key K and V tile into a 2-stage
//     ring in shared memory that runs on across items. Each arrival is
//     signalled on an mbarrier, K and V separately, so the scores can
//     start before V lands; each stage's K is released after its scores,
//     its V after its P V.
//   - Each of the two consumer warpgroups owns 64 queries: wgmma
//     S = Q K^T (both from shared memory, fp32 accumulator); mask, soft-cap
//     and online softmax in registers (fp32, exp2 by the MUFU unit); wgmma
//     O += P V with P as the register A operand and V read from shared
//     memory (MN-major).
//   - The probabilities stay fp32 to ~16 bits: P = P_hi + P_lo with
//     P_hi = bf16(p) and P_lo = bf16(p - P_hi), and the P V product runs
//     once for each, with the same V tile.
//   - Overlap: the scores of tile i + 1 are issued before the P V of tile
//     i, so tile i + 1's softmax (CUDA cores) runs while tile i's P V
//     (tensor cores) does; and the two consumer warpgroups take turns to
//     issue (named barriers), so one's softmax runs under the other's
//     products.
//   - Operand tiles are 64-column blocks of 128-byte rows in the TMA's
//     128-byte swizzle, which the wgmma descriptors name.
//   - Key tiles run from the first one inside the window to the diagonal;
//     masks are applied only on tiles where causality or the window can
//     bite. The grid puts the longest query tiles (the last ones) first,
//     so the causal triangle's short tiles fill the tail.
//   - setmaxnreg moves registers from the producer to the consumers.
//   - Tensor maps are encoded per call on the host (the driver's
//     cuTensorMapEncodeTiled, reached through the runtime's driver entry
//     point, so nothing links libcuda) and passed as __grid_constant__
//     parameters, so a CUDA-graph capture records them.
//
// fp32: flash_fwd, on the CUDA cores (tensor cores take fp32 only as TF32,
//   which would not meet the fp32 tolerance). One block of 128 threads per
//   (64-query tile, q head, row); Q, K and V tiles staged in shared memory
//   as fp32; a thread owns 4 queries x 8 keys of the score tile and 4
//   queries x D/8 output columns.
//
// Shared memory: bf16 2 x (D/64 x 16 KB) Q + 2 stages x 2 x (D/64 x 16 KB)
// K/V = 192 KB at D = 128, 96 KB at D = 64; fp32 113 KB at D = 128
// (dynamic, opted in once per instantiation, before any CUDA-graph
// capture).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int NT = 128;
constexpr int BQ = 64;     // queries per block
constexpr int BK = 64;     // keys per tile
constexpr int QR = 4;      // queries per thread
constexpr int KC = 8;      // key columns per thread (BK / 8 threads)

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// rows x D fp32 elements of one head, from (B, S, H, D) through strides,
// into shared memory (row stride ld)
template <int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const float* __restrict__ src,
                                      int64_t row_stride) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < BQ * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(src + r * row_stride + c);
    dst[r * ld + c] = x.x;
    dst[r * ld + c + 1] = x.y;
    dst[r * ld + c + 2] = x.z;
    dst[r * ld + c + 3] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int hq,
          int hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
          int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
          int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
          int window, float scale, float soft_cap) {
  constexpr int DC = D / 8;                 // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                         // BQ x (D+1)
  float* sK = sQ + BQ * (D + 1);            // BK x (D+1)
  float* sV = sK + BK * (D + 1);            // BK x D
  float* sP = sV + BK * D;                  // BQ x (BK+1)

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 8;                   // query group: rows ty*4 .. +3
  const int tx = tid % 8;                   // key / column lane
  const int q0 = qt * BQ;

  stage<D>(sQ, D + 1, q + b * q_sb + (int64_t)q0 * q_ss + h * q_sh, q_ss);

  float m[QR], l[QR], acc[QR][DC];
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int kt_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int kt_hi = (q0 + BQ - 1) / BK;     // the diagonal tile
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                        // the previous tile is consumed
    stage<D>(sK, D + 1, k + b * k_sb + (int64_t)k0 * k_ss + kvh * k_sh,
             k_ss);
    stage<D>(sV, D, v + b * v_sb + (int64_t)k0 * v_ss + kvh * v_sh, v_ss);
    __syncthreads();

    // scores: 4 queries x 8 keys (keys tx, tx + 8, ...)
    float s[QR][KC];
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[QR], kv[KC];
#pragma unroll
      for (int i = 0; i < QR; ++i) qv[i] = sQ[(ty * QR + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < KC; ++j) kv[j] = sK[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] += qv[i] * kv[j];
    }

    // mask, online softmax over the 8 lanes of a query group
#pragma unroll
    for (int i = 0; i < QR; ++i) {
      const int qp = q0 + ty * QR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kp = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
        const bool ok = kp <= qp && (window <= 0 || qp - kp < window);
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * QR + i) * (BK + 1) + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V: 4 queries x D/8 columns (columns tx, tx + 8, ...)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i) pv[i] = sP[(ty * QR + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < QR; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

  // causal: every query attends at least itself, so l > 0
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int qp = q0 + ty * QR + i;
    float* o = out + b * o_sb + (int64_t)qp * o_ss + h * o_sh;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 8 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int batch, int seq, int hq, int hkv, const int64_t* st,
                int window, float scale, float soft_cap,
                cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool opted_in = false;   // once per instantiation, before any
  if (!opted_in) {                // CUDA-graph capture of a launch
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid(seq / BQ, hq, batch);
  flash_fwd<D><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], window, scale, soft_cap);
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (TMA + mbarrier ring + wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;        // queries per block (2 consumers x 64)
constexpr int TC_BN = 128;        // keys per tile
constexpr int TC_STAGES = 2;
constexpr int TC_THREADS = 384;   // consumers: warpgroups 0-1; producer: 2
constexpr float LOG2E = 1.4426950408889634f;

// One operand tile: D/64 column blocks of `rows` x 64 bf16 (128-byte rows,
// 128-byte swizzle), each block 1024-byte aligned.
template <int D>
struct TcSmem {
  __nv_bfloat16 q[2][D / 64][TC_BM * 64];      // two work items' Q
  __nv_bfloat16 k[TC_STAGES][D / 64][TC_BN * 64];
  __nv_bfloat16 v[TC_STAGES][D / 64][TC_BN * 64];
  uint64_t q_full[2];
  uint64_t q_empty[2];
  uint64_t k_full[TC_STAGES];
  uint64_t v_full[TC_STAGES];
  uint64_t k_empty[TC_STAGES];
  uint64_t v_empty[TC_STAGES];
};

template <int D>
constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(TcSmem<D>)) + 1024;   // + alignment slack
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 4-d TMA load of one box at (c0, c1, c2, c3) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (offsets in bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers 8 and 9 pass the turn to issue wgmma between the two
// consumer warpgroups (bar.sync by the one whose turn it is, bar.arrive by
// the other: 256 threads).
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(8 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(8 + (1 - wg)) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma (it sees each asm as complete when issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define NXDI_F8(d, b)                                                      \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),          \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define NXDI_F32(d) NXDI_F8(d, 0), NXDI_F8(d, 8), NXDI_F8(d, 16), NXDI_F8(d, 24)
#define NXDI_F64(d) NXDI_F32(d), NXDI_F8(d, 32), NXDI_F8(d, 40),            \
      NXDI_F8(d, 48), NXDI_F8(d, 56)
#define NXDI_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, "
#define NXDI_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}, "

// d (64 x 128, fp32) (+)= A (64 x 16, shared, K-major) B (16 x 128,
// shared, K-major): the scores.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NXDI_R64
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : NXDI_F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NXDI_R64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : NXDI_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NXDI_R32
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : NXDI_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

// 2^x by the MUFU unit (relative error ~2^-22; 2^-huge flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// A work item is one (128-query tile, q head, row); item w takes query
// tile n_qt - 1 - w / (Hq * B) (the longest first) of head w % Hq, row
// (w / Hq) % B. Persistent grid: block j takes items j, j + gridDim.x, ...,
// so the producer loads the next item's Q and first K/V tiles while the
// consumers finish the current one.
struct WorkItem {
  int h, b, q0, kt_lo, n_tiles;
};

__device__ __forceinline__ WorkItem work_item(int w, int hq, int batch,
                                              int n_qt, int window) {
  WorkItem it;
  const int x = w % (hq * batch);
  it.h = x % hq;
  it.b = x / hq;
  it.q0 = (n_qt - 1 - w / (hq * batch)) * TC_BM;
  it.kt_lo = window > 0 ? max(it.q0 - window + 1, 0) / TC_BN : 0;
  it.n_tiles = (it.q0 + TC_BM - 1) / TC_BN - it.kt_lo + 1;  // to diagonal
  return it;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc(const __grid_constant__ CUtensorMap q_map,
         const __grid_constant__ CUtensorMap k_map,
         const __grid_constant__ CUtensorMap v_map,
         __nv_bfloat16* __restrict__ out, int hq, int hkv, int batch,
         int n_qt, int64_t o_sb, int64_t o_ss, int64_t o_sh, int window,
         float scale, float soft_cap) {
  constexpr int KB = D / 64;                       // column blocks
  constexpr int NO = D / 2;                        // O registers / thread
  constexpr uint32_t TILE_BYTES = TC_BN * D * 2;   // one K or V tile
  extern __shared__ char smem_raw[];
  TcSmem<D>& sm = *reinterpret_cast<TcSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n_work = n_qt * hq * batch;
  const int group = hq / hkv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) {
      mbar_init(&sm.q_full[j], 1);
      mbar_init(&sm.q_empty[j], 256);
    }
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 256);              // every consumer thread
      mbar_init(&sm.v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int c = 0;                                   // the block's tile count
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        const WorkItem wi = work_item(w, hq, batch, n_qt, window);
        const int kvh = wi.h / group;
        const int qb = it & 1;
        if (it >= 2) mbar_wait(&sm.q_empty[qb], ((it / 2) - 1) & 1);
        mbar_expect_tx(&sm.q_full[qb], TC_BM * D * 2);
#pragma unroll
        for (int j = 0; j < KB; ++j)
          tma_load(sm.q[qb][j], &q_map, &sm.q_full[qb], 64 * j, wi.q0, wi.h,
                   wi.b);
        for (int i = 0; i < wi.n_tiles; ++i, ++c) {
          const int st = c % TC_STAGES;
          const uint32_t used = ((c / TC_STAGES) - 1) & 1;
          const int k0 = (wi.kt_lo + i) * TC_BN;
          if (c >= TC_STAGES) mbar_wait(&sm.k_empty[st], used);
          mbar_expect_tx(&sm.k_full[st], TILE_BYTES);
#pragma unroll
          for (int j = 0; j < KB; ++j)
            tma_load(sm.k[st][j], &k_map, &sm.k_full[st], 64 * j, k0, kvh,
                     wi.b);
          if (c >= TC_STAGES) mbar_wait(&sm.v_empty[st], used);
          mbar_expect_tx(&sm.v_full[st], TILE_BYTES);
#pragma unroll
          for (int j = 0; j < KB; ++j)
            tma_load(sm.v[st][j], &v_map, &sm.v_full[st], 64 * j, k0, kvh,
                     wi.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = 16 * warp + lane / 4;         // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    float o[NO];
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};                       // this thread's share
    int qb = 0, qw = 0, qp[2] = {0, 0};

    // S = Q K^T of the tile in stage st, over D in steps of 16 (issued,
    // not waited for)
    auto issue_qk = [&](int st) {
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = smem_desc(
            &sm.q[qb][kk / 4][(64 * wg) * 64 + (kk % 4) * 16], 16, 1024);
        const uint64_t db =
            smem_desc(&sm.k[st][kk / 4][(kk % 4) * 16], 16, 1024);
        wgmma_ss_n128(s, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage st, P = P_hi + P_lo (issued, not
    // waited for)
    uint32_t ph[32], pl[32];
    auto issue_pv = [&](int st) {
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BN / 16; ++kk) {
        const uint64_t db =
            smem_desc(&sm.v[st][0][kk * 16 * 64], TC_BN * 64 * 2, 1024);
        wgmma_pv<D>(o, &ph[4 * kk], db);
        wgmma_pv<D>(o, &pl[4 * kk], db);
      }
      wgmma_commit();
    };
    // mask, soft-cap and online softmax of the scores of keys k0 .. k0 +
    // 127 (log2 domain): s becomes p, (m, l) move on; returns the factor
    // the accumulator must be rescaled by
    auto softmax = [&](int k0, float (&alpha)[2]) {
      const bool causal_bites = k0 + TC_BN - 1 > qw;
      const bool window_bites = window > 0 && qw + 63 - k0 >= window;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e % 4) >= 2;
        float x;
        if (soft_cap > 0.f)
          x = soft_cap * tanhf(s[e] * scale / soft_cap) * LOG2E;
        else
          x = s[e] * sl2;
        if (causal_bites || window_bites) {
          const int kp = k0 + 8 * (e / 4) + col0 + (e % 2);
          const bool ok =
              kp <= qp[r] && (window <= 0 || qp[r] - kp < window);
          x = ok ? x : NEG_INF;
        }
        s[e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = fast_exp2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int r = (e % 4) >= 2;
        const float p = fast_exp2(s[e] - m[r]);
        s[e] = p;
        l[r] += p;
      }
    };
    // P as register A fragments: k-step kk covers keys 16 kk .. 16 kk + 15,
    // i.e. score registers 8 kk .. 8 kk + 7
    auto to_p = [&]() {
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float a = s[2 * t], c = s[2 * t + 1];
        ph[t] = pack_bf16(a, c);
        const __nv_bfloat162 hv =
            *reinterpret_cast<__nv_bfloat162*>(&ph[t]);
        pl[t] = pack_bf16(a - __low2float(hv), c - __high2float(hv));
      }
    };

    // Tile i's P V runs on the tensor cores while tile i + 1's softmax
    // runs on the CUDA cores: scores i + 1 are issued before P V i. The two
    // warpgroups take turns to issue (warpgroup 0 first), so one's softmax
    // runs while the other's products do. c counts the block's tiles (the
    // ring's stage and phase); the loop body has no branch between a wgmma
    // and the wait that retires it, so the compiler can tell which group
    // each wait retires.
    float alpha[2];
    if (wg == 1) turn_pass(wg);
    int c = 0;
    for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
      const WorkItem wi = work_item(w, hq, batch, n_qt, window);
      qb = it & 1;
      qw = wi.q0 + 64 * wg;                        // the warpgroup's first
      qp[0] = qw + row0;
      qp[1] = qw + row0 + 8;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
      mbar_wait(&sm.q_full[qb], (it / 2) & 1);
      mbar_wait(&sm.k_full[c % TC_STAGES], (c / TC_STAGES) & 1);
      turn_wait(wg);
      issue_qk(c % TC_STAGES);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&sm.k_empty[c % TC_STAGES]);
      softmax(wi.kt_lo * TC_BN, alpha);
      to_p();
      for (int i = 0; i + 1 < wi.n_tiles; ++i, ++c) {
        const int st = c % TC_STAGES;
        const int st1 = (c + 1) % TC_STAGES;
        mbar_wait(&sm.k_full[st1], ((c + 1) / TC_STAGES) & 1);
        mbar_wait(&sm.v_full[st], (c / TC_STAGES) & 1);
        turn_wait(wg);
        issue_qk(st1);
        issue_pv(st);
        turn_pass(wg);
        wgmma_wait<1>();                 // the scores, not P V
        fence_regs(s);
        mbar_arrive(&sm.k_empty[st1]);
        softmax((wi.kt_lo + i + 1) * TC_BN, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&sm.v_empty[st]);
#pragma unroll
        for (int e = 0; e < NO; ++e) o[e] *= alpha[(e % 4) >= 2];
        to_p();
      }
      mbar_wait(&sm.v_full[c % TC_STAGES], (c / TC_STAGES) & 1);
      turn_wait(wg);
      issue_pv(c % TC_STAGES);
      turn_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&sm.v_empty[c % TC_STAGES]);
      mbar_arrive(&sm.q_empty[qb]);
      ++c;

      // causal: every query attends at least itself, so l > 0
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t = l[r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        inv[r] = 1.f / t;
      }
#pragma unroll
      for (int e = 0; e < NO; e += 2) {
        const int r = (e % 4) >= 2;
        const int col = 8 * (e / 4) + col0;
        __nv_bfloat16* dst = out + wi.b * o_sb + (int64_t)qp[r] * o_ss +
                             wi.h * o_sh + col;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[e] * inv[r], o[e + 1] * inv[r]);
      }
    }
  }
}

#undef NXDI_F8
#undef NXDI_F32
#undef NXDI_F64
#undef NXDI_R32
#undef NXDI_R64

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda
// link); null if the driver does not offer it.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (B, S, H, D) bf16 through element strides (seq, head, batch), boxes of
// 64 columns x `rows` rows of one (head, row), 128-byte swizzle.
bool make_map(CUtensorMap* map, EncodeTiledFn enc, const void* base, int d,
              int seq, int heads, int batch, int64_t s_s, int64_t s_h,
              int64_t s_b, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_s * 2, (cuuint64_t)s_h * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int seq, int hq, int hkv, const int64_t* st,
                int window, float scale, float soft_cap,
                cudaStream_t stream) {
  const int bytes = tc_smem_bytes<D>();
  static bool opted_in = false;   // once per instantiation, before any
  if (!opted_in) {                // CUDA-graph capture of a launch
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return -2;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, enc, q, D, seq, hq, batch, st[1], st[2], st[0],
                TC_BM) ||
      !make_map(&km, enc, k, D, seq, hkv, batch, st[4], st[5], st[3],
                TC_BN) ||
      !make_map(&vm, enc, v, D, seq, hkv, batch, st[7], st[8], st[6],
                TC_BN))
    return -3;
  static int n_sm = 0;            // the card's SMs: one block each
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = seq / TC_BM;
  const int n_work = n_qt * hq * batch;
  flash_tc<D><<<min(n_sm, n_work), TC_THREADS, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), hq, hkv, batch, n_qt,
      st[9], st[10], st[11], window, scale, soft_cap);
  return 0;
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, out, each
// tensor's last dim contiguous. in_dtype: 0 = fp32 (S a multiple of 64),
// 1 = bf16 (S a multiple of 128, every stride a multiple of 8 elements,
// 16-byte aligned bases). Returns cudaGetLastError() after the launch, -1
// for a shape the kernel does not take (the Python wrapper checks those
// first), -2 if the driver offers no cuTensorMapEncodeTiled, -3 if it
// refuses a tensor map.
extern "C" int nxdi_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int hq, int hkv, int head_dim,
                                    const int64_t* strides, int window,
                                    float scale, float soft_cap, int in_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv) return -1;
  int rc = -1;
  if (in_dtype == 0 && seq % BQ == 0) {
    if (head_dim == 64)
      rc = launch_fp32<64>(q, k, v, out, batch, seq, hq, hkv, strides,
                           window, scale, soft_cap, st);
    else if (head_dim == 128)
      rc = launch_fp32<128>(q, k, v, out, batch, seq, hq, hkv, strides,
                            window, scale, soft_cap, st);
  } else if (in_dtype == 1 && seq % TC_BM == 0) {
    if (head_dim == 64)
      rc = launch_bf16<64>(q, k, v, out, batch, seq, hq, hkv, strides,
                           window, scale, soft_cap, st);
    else if (head_dim == 128)
      rc = launch_bf16<128>(q, k, v, out, batch, seq, hq, hkv, strides,
                            window, scale, soft_cap, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
