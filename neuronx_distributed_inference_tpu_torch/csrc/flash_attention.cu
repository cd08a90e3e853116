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
// (q, k, v read once, out written once, at 3.35 TB/s) bound it only for short
// rows. This first version does its products on the CUDA cores in fp32
// (67 TFLOP/s peak), so it sits far below the tensor-core bound; mma/wgmma
// tiles with TMA loads are later work.
// What the design does: one block of 128 threads per (64-query tile, q head,
// row). The block keeps its Q tile in shared memory and walks the key tiles
// from the first one inside the window, max(0, q0 - w + 1) / 64, to the
// diagonal tile (causal and out-of-window tiles are never read), staging each
// 64-key K and V tile in shared memory as fp32 with 16-byte loads. A thread
// owns 4 queries x 8 keys of the score tile and 4 queries x D/8 columns of
// the output; row max and sum reduce over the 8 threads of a query group by
// warp shuffles. Causal and window masks are applied per element (they only
// bite on the boundary tiles). q/k/v are read in the model's (B, S, H, D)
// layout through strides, so no transposed copies are made.
//
// Shared memory: (64 x (D+1)) Q + (64 x (D+1)) K + (64 x D) V + (64 x 65) P
// floats = 113 KB at D = 128, 65 KB at D = 64 (dynamic, opted in).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.3819763e38f;
constexpr int NT = 128;
constexpr int BQ = 64;     // queries per block
constexpr int BK = 64;     // keys per tile
constexpr int QR = 4;      // queries per thread
constexpr int KC = 8;      // key columns per thread (BK / 8 threads)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// rows x D elements of one head, from (B, S, H, D) through strides, into
// shared memory (row stride ld) as fp32
template <typename TIN, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const TIN* __restrict__ src,
                                      int64_t row_stride) {
  constexpr int EPV = 16 / sizeof(TIN);
  constexpr int VPR = D / EPV;
  for (int i = threadIdx.x; i < BQ * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * EPV;
    const Vec16<TIN> x =
        *reinterpret_cast<const Vec16<TIN>*>(src + r * row_stride + c);
#pragma unroll
    for (int e = 0; e < EPV; ++e) dst[r * ld + c + e] = to_f(x.v[e]);
  }
}

template <typename TIN, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const TIN* __restrict__ q, const TIN* __restrict__ k,
          const TIN* __restrict__ v, TIN* __restrict__ out, int hq, int hkv,
          int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
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

  stage<TIN, D>(sQ, D + 1, q + b * q_sb + (int64_t)q0 * q_ss + h * q_sh,
                q_ss);

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
    stage<TIN, D>(sK, D + 1,
                  k + b * k_sb + (int64_t)k0 * k_ss + kvh * k_sh, k_ss);
    stage<TIN, D>(sV, D, v + b * v_sb + (int64_t)k0 * v_ss + kvh * v_sh,
                  v_ss);
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
    TIN* o = out + b * o_sb + (int64_t)qp * o_ss + h * o_sh;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) store(o + tx + 8 * j, acc[i][j] * inv);
  }
}

template <typename TIN, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, int seq, int hq, int hkv, const int64_t* st,
           int window, float scale, float soft_cap, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool opted_in = false;   // once per instantiation, before any
  if (!opted_in) {                // CUDA-graph capture of a launch
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<TIN, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  dim3 grid(seq / BQ, hq, batch);
  flash_fwd<TIN, D><<<grid, NT, bytes, stream>>>(
      static_cast<const TIN*>(q), static_cast<const TIN*>(k),
      static_cast<const TIN*>(v), static_cast<TIN*>(out), hq, hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], window, scale, soft_cap);
  return 0;
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, out, each
// tensor's last dim contiguous. in_dtype: 0 = fp32, 1 = bf16. Returns
// cudaGetLastError() after the launch, or -1 for a shape the kernel does
// not take (the Python wrapper checks those first).
extern "C" int nxdi_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int seq, int hq, int hkv, int head_dim,
                                    const int64_t* strides, int window,
                                    float scale, float soft_cap, int in_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq % BQ || hkv < 1 || hq % hkv) return -1;
  int rc = -1;
  if (head_dim == 64 && in_dtype == 0)
    rc = launch<float, 64>(q, k, v, out, batch, seq, hq, hkv, strides,
                           window, scale, soft_cap, st);
  else if (head_dim == 64 && in_dtype == 1)
    rc = launch<__nv_bfloat16, 64>(q, k, v, out, batch, seq, hq, hkv,
                                   strides, window, scale, soft_cap, st);
  else if (head_dim == 128 && in_dtype == 0)
    rc = launch<float, 128>(q, k, v, out, batch, seq, hq, hkv, strides,
                            window, scale, soft_cap, st);
  else if (head_dim == 128 && in_dtype == 1)
    rc = launch<__nv_bfloat16, 128>(q, k, v, out, batch, seq, hq, hkv,
                                    strides, window, scale, soft_cap, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
