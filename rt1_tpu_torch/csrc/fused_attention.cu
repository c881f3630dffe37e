// Fused masked attention forward for Hopper (sm_90a): the simple kernel.
//
// Replaces the Pallas TPU kernel `_attention_kernel` in
// rt1_tpu/parallel/flash_attention.py (wrapper `fused_attention`) for
// float32 inputs, and for bfloat16 inputs that the tensor-core kernel
// (fused_attention_tc.cu) does not take: d not a multiple of 16, or rows
// not 16-byte aligned (the rule is `_variant` in
// rt1_tpu_torch/parallel/flash_attention.py). float32 stays here because
// its products run in full fp32 on the CUDA cores: the tensor cores would
// round them to TF32, and the float32 path is the one held to the CPU.
// Per (batch, head) it computes
//
//   out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v
//
// with logits, softmax and the PV product in fp32 and the result cast to
// q's dtype (float32 or bfloat16). q, k, v and out are (b, s, h, d) read
// through their strides (the last dim must be contiguous); the optional
// mask is a dense (s, s) uint8 array shared by every (batch, head).
//
// Design. The grid is (b*h, ceil(s / BLOCK_Q)); a block of 128 threads
// (4 warps) owns BLOCK_Q = 16 query rows. It stages its Q tile in shared
// memory once, then walks the key axis in tiles of BLOCK_K = 32 rows,
// staging each K and V tile through shared memory and keeping an fp32
// online softmax (running max m, running sum l, and the output
// accumulator in registers). Warp w owns query rows 4w..4w+3 for the
// scores and the softmax; lane j owns key j of the tile, so a row's max
// and sum are one warp shuffle reduction. For the PV product each thread
// owns output columns tid, tid + 128 for all 16 rows, reading four keys'
// probabilities per 128-bit load. K and V rows are padded by one float in
// shared memory so that lanes reading 32 different rows of one column hit
// 32 different banks; P rows are 32 floats, so they stay 16-byte aligned.
//
// Masked logits are -1e9 (the JAX kernel's fill) and key positions past s
// are -inf; the running max starts at -inf. So a fully masked row comes
// out as the plain mean of its s real value rows, like
// rt1_tpu/parallel/ring_attention.py::dense_attention_reference, and not
// the mean over padding that the Pallas wrapper's Mosaic padding gives.
//
// Bound at the serve shape (b = 8, s = 66, h = 8, d = 128, bf16): q, k, v
// and out move 4 * 8*66*8*128 * 2 B = 4.33 MB, i.e. 1.29 us at 3.35 TB/s;
// the two products are 4 * b*h*s*s*d = 0.143 GFLOP, 0.14 us at the bf16
// tensor-core peak. So the function is bound by memory and, at 1-2 us, by
// launch latency. This simple kernel is far from that bound (PERF.md has
// its times): each block's chain of dependent global loads, shared-memory
// loads and warp shuffles sets its time, and the 64-320 blocks of the
// serve shapes are too few per SM to hide it. What the design leaves on
// the table: the products run on CUDA cores in fp32 (no wgmma/mma.sync),
// tiles are loaded with scalar loads instead of TMA or cp.async (no
// overlap of loads with math), and each block re-reads K and V of its
// (batch, head), so K/V are read ceil(s / 16) times (from L2 after the
// first). The bf16 serve path now runs fused_attention_tc.cu, which
// answers those points; this kernel keeps float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 16;
constexpr int BLOCK_K = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BLOCK_Q / WARPS;  // 4
constexpr float MASK_FILL = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long b, s, h;  // in elements; the d stride is 1
};

// NC = number of 128-wide column groups of the head dim (d <= 128 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int h, int s, int d, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dp = d + 1;                   // padded K/V row
  float* q_tile = smem;                   // BLOCK_Q * d
  float* k_tile = q_tile + BLOCK_Q * d;   // BLOCK_K * dp
  float* v_tile = k_tile + BLOCK_K * dp;  // BLOCK_K * dp
  float* p_tile = v_tile + BLOCK_K * dp;  // BLOCK_Q * BLOCK_K
  float* alpha = p_tile + BLOCK_Q * BLOCK_K;  // BLOCK_Q
  float* row_l = alpha + BLOCK_Q;             // BLOCK_Q

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  T* ob = out + bi * os.b + hi * os.h;

  // Q tile, pre-scaled like the JAX kernel's `q * scale`; rows past s are 0.
  // Threads walk a row's columns, so a warp's loads are contiguous.
#pragma unroll 4
  for (int r = 0; r < BLOCK_Q; ++r) {
    const int qi = q0 + r;
    for (int c = tid; c < d; c += THREADS)
      q_tile[r * d + c] = qi < s ? to_float(qb[qi * qs.s + c]) * scale : 0.f;
  }

  // Online-softmax state of this warp's rows (replicated across its lanes).
  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[BLOCK_Q][NC];
#pragma unroll
  for (int r = 0; r < BLOCK_Q; ++r)
#pragma unroll
    for (int g = 0; g < NC; ++g) acc[r][g] = 0.f;

  for (int k0 = 0; k0 < s; k0 += BLOCK_K) {
    __syncthreads();  // previous tile fully consumed (and Q tile written)
    // Unrolled over rows so several global loads are in flight per thread.
#pragma unroll 8
    for (int r = 0; r < BLOCK_K; ++r) {
      const int kj = k0 + r;
      for (int c = tid; c < d; c += THREADS) {
        k_tile[r * dp + c] = kj < s ? to_float(kb[kj * ks.s + c]) : 0.f;
        v_tile[r * dp + c] = kj < s ? to_float(vb[kj * vs.s + c]) : 0.f;
      }
    }
    __syncthreads();

    // Scores: warp `warp` owns 4 rows, lane = key column. The 4 dot
    // products run side by side (one K load feeds 4 FMAs, 4 independent
    // chains), then the softmax update per row.
    const int kj = k0 + lane;
    const float* kr = k_tile + lane * dp;
    const float* qw = q_tile + warp * ROWS_PER_WARP * d;
    float dot[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) dot[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float kc = kr[c];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) dot[r] = fmaf(qw[r * d + c], kc, dot[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = warp * ROWS_PER_WARP + r;
      const int qi = q0 + row;
      float logit = -INFINITY;
      if (kj < s) {
        logit = dot[r];
        if (mask != nullptr && qi < s && mask[(long long)qi * s + kj] == 0) logit = MASK_FILL;
      }
      float tile_max = logit;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      // Every tile holds at least one real key, so m_new is finite.
      const float m_new = fmaxf(m_run[r], tile_max);
      const float p = expf(logit - m_new);
      float tile_sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      const float a = expf(m_run[r] - m_new);  // 0 on the first tile
      l_run[r] = l_run[r] * a + tile_sum;
      m_run[r] = m_new;
      p_tile[row * BLOCK_K + lane] = p;
      if (lane == 0) alpha[row] = a;
    }
    __syncthreads();

    // acc = alpha * acc + P V for this thread's columns.
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      const int c = tid + g * THREADS;
      if (c < d) {
#pragma unroll
        for (int r = 0; r < BLOCK_Q; ++r) acc[r][g] *= alpha[r];
        // Four keys at a time: one 128-bit (broadcast) load of P per row.
        for (int j = 0; j < BLOCK_K; j += 4) {
          const float v0 = v_tile[j * dp + c], v1 = v_tile[(j + 1) * dp + c];
          const float v2 = v_tile[(j + 2) * dp + c], v3 = v_tile[(j + 3) * dp + c];
#pragma unroll
          for (int r = 0; r < BLOCK_Q; ++r) {
            const float4 p = *reinterpret_cast<const float4*>(p_tile + r * BLOCK_K + j);
            float a = fmaf(p.x, v0, acc[r][g]);
            a = fmaf(p.y, v1, a);
            a = fmaf(p.z, v2, a);
            acc[r][g] = fmaf(p.w, v3, a);
          }
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) row_l[warp * ROWS_PER_WARP + r] = l_run[r];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NC; ++g) {
    const int c = tid + g * THREADS;
    if (c < d) {
#pragma unroll
      for (int r = 0; r < BLOCK_Q; ++r) {
        const int qi = q0 + r;
        if (qi < s) from_float(ob + qi * os.s + c, acc[r][g] / row_l[r]);
      }
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) *
      (size_t)(BLOCK_Q * d + 2 * BLOCK_K * (d + 1) + BLOCK_Q * BLOCK_K + 2 * BLOCK_Q);
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int b, int s, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
  // The dynamic shared-memory limit is set once per instance, for its
  // largest head dim (128 * NC).
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_attention_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(128 * NC));
  if (attr != cudaSuccess) return attr;
  dim3 grid(b * h, (s + BLOCK_Q - 1) / BLOCK_Q);
  fused_attention_kernel<T, NC><<<grid, THREADS, smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), h, s, d, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success); the Python wrapper raises on
// anything else. d must lie in [1, 256] and s >= 1 (checked there too).
extern "C" int rt1_fused_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int dtype, int b, int s,
                                       int h, int d, long long q_sb, long long q_ss,
                                       long long q_sh, long long k_sb, long long k_ss,
                                       long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, long long o_sb, long long o_ss,
                                       long long o_sh, float scale, void* stream) {
  if (b < 1 || s < 1 || h < 1 || d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d <= 128 ? launch<float, 1>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, st)
                   : launch<float, 2>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, st);
  } else if (dtype == 1) {
    err = d <= 128
        ? launch<__nv_bfloat16, 1>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, st)
        : launch<__nv_bfloat16, 2>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
