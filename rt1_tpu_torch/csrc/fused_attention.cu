// Fused masked attention forward for Hopper (sm_90a): the simple kernel.
//
// Replaces the Pallas TPU kernel `_attention_kernel` in
// rt1_tpu/parallel/flash_attention.py (wrapper `fused_attention`) for every
// call that the two tensor-core kernels do not take (the rule is `_variant`
// in rt1_tpu_torch/parallel/flash_attention.py): bf16 with d not a multiple
// of 16, float32 with d not a multiple of 8, and rows off 16-byte
// alignment. Its main path is the `tiny` config's bf16 `infer_step`, at
// (b, s, h, d) = (2, 15, 2, 8). Per (batch, head) it computes
//
//   out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v
//
// with the products in full fp32 on the CUDA cores (no TF32 anywhere),
// logits, softmax and the PV product in fp32, and the result cast to q's
// dtype (float32 or bfloat16). q, k, v and out are (b, s, h, d) read
// through their strides (the last dim contiguous); any d in [1, 256], any
// s >= 1; the optional mask is a dense (s, s) uint8 array shared by every
// (batch, head).
//
// What bounds it at its path's shape. q, k, v and out are 4 * 2*15*2*8 *
// 2 B = 3.8 KB, 1.2 ns at 3.35 TB/s, and the products 4 * b*h*s*s*d =
// 29 kFLOP: nothing. The time is the launch and one block's chain of
// dependent steps: global loads, a barrier, the scores, two warp
// reductions, PV, the stores. The design keeps that chain short:
//
// * Loads are spread over (row, chunk) pairs of all the block's threads,
//   Q, K and V together, and each thread issues all of its loads of a
//   batch (8 of 16 bytes, or 16 elements) before it reads any of them, so
//   a tile that fits a batch is one round trip to memory (at the path's
//   shape 48 chunks of 16 bytes, one a thread), not one per row. A chunk
//   is 16 bytes (one bf16 row at d = 8) where every base pointer, every
//   stride and d allow it, one element otherwise. A lane's mask bytes are
//   loaded into registers beside the tile, in the same round trip.
// * The key tile is sized to s: each lane scores KPL keys (1-4), so that s
//   <= 32 * KPL takes one pass (up to 128 keys at d <= 64, 96 at d <= 128,
//   32 above). A longer sequence walks tiles with an online softmax (the
//   running max and sum, the accumulators rescaled by exp(m_old - m_new)).
//   Lane j of warp w scores keys j, j + 32, ... against the block's rows
//   4w..4w+3; a row's max and sum are one warp reduction each, the 4 rows'
//   shuffles side by side.
// * The PV product runs in the warp that owns the rows, so no barrier
//   separates it from the softmax, and it is spread over (row, 4-column
//   chunk) items: at d <= 64 a lane owns one row and its chunks (at d = 8
//   the warp's 8 items take 8 lanes), above it a chunk of all 4 rows.
// * One barrier a tile (two between tiles); one pass and one block per
//   (batch, head) at the path's shape.
//
// At serve scale, (8, 66, 8, 128) in float32 (the rule gives it to
// tf32x3; this kernel takes it where forced, and calls of that size with
// other head dims or rows off alignment), q, k, v and out are 8.65 MB,
// 2.58 us at 3.35 TB/s, and the products 0.143 GFLOP, 2.1 us at the 67
// TFLOP/s of fp32 outside the tensor cores. There three things bound it,
// and the design answers each:
//
// * Bytes: every block stages the K and V of its (batch, head). A block
//   takes up to MAX_SLICES slices of 16 query rows (one warp per 4 rows),
//   as many as keep one block for each SM (the C entry), so K and V are
//   read twice per (batch, head) at s = 66 instead of once per 16 rows.
// * Shared-memory reads of the two products: a lane's 4 broadcast Q reads
//   and KPL K reads of 16 bytes feed 16 * KPL FMAs (K rows are padded to an
//   odd number of 16-byte units, so the reads of 8 lanes fall in 8 bank
//   groups), and above d = 64 one V read feeds 4 rows of PV.
// * Latency: a block's phases (loads, scores, softmax, PV) run one after
//   another, and at one block an SM nothing overlaps them. What is left on
//   the table: the tensor cores (the float32 path must stay exact fp32,
//   and at d = 8 they have no depth to fill), K and V in bf16 in shared
//   memory, copies that overlap the math (cp.async or TMA).
//
// Masked logits are -1e9 (the JAX kernel's fill) and key positions past s
// are -inf; the running max starts at -inf. So a fully masked row comes
// out as the plain mean of its s real value rows, like
// rt1_tpu/parallel/ring_attention.py::dense_attention_reference, and not
// the mean over padding that the Pallas wrapper's Mosaic padding gives.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int SLICE = 16;          // query rows a slice: 4 warps of 4 rows
constexpr int SLICE_THREADS = 128;
constexpr int MAX_SLICES = 3;      // slices a block
constexpr int ROWS_PER_WARP = 4;
constexpr float MASK_FILL = -1e9f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T (4 floats or 8 bf16) as floats times `mul`, stored at
// `dst` (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store_chunk(float* dst, uint4 u, float mul) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  if constexpr (std::is_same<T, float>::value) {
    d4[0] = make_float4(__uint_as_float(u.x) * mul, __uint_as_float(u.y) * mul,
                        __uint_as_float(u.z) * mul, __uint_as_float(u.w) * mul);
  } else {
    // A 32-bit word holds two bf16: the low half is the first element.
    auto lo = [](unsigned w) { return __uint_as_float(w << 16); };
    auto hi = [](unsigned w) { return __uint_as_float(w & 0xffff0000u); };
    d4[0] = make_float4(lo(u.x) * mul, hi(u.x) * mul, lo(u.y) * mul, hi(u.y) * mul);
    d4[1] = make_float4(lo(u.z) * mul, hi(u.z) * mul, lo(u.w) * mul, hi(u.w) * mul);
  }
}

struct Strides {
  long long b, s, h;  // in elements; the d stride is 1
};

// One tile's staging: virtual row R < nq is Q row R (scaled), then nk rows
// of K, then nk rows of V; rows past `*_valid` and columns past d are zero.
struct Stage {
  const void* q;  // first row of each source for this tile
  const void* k;
  const void* v;
  long long qss, kss, vss;  // row strides in elements
  int nq, q_valid;          // Q rows staged (the block's rows, or 0) and real
  int q_rows;               // Q rows in shared memory (K follows them)
  int nk, k_valid;          // K/V rows staged (a multiple of 4) and real
  int d, dq, dk;            // head dim; smem row strides of Q/V and of K
  float scale;
};

// Stages a tile with chunks of W elements (W = 16 / sizeof(T) where every
// row is 16-byte aligned and d % W == 0, else 1). Each thread issues up to
// L loads, then converts and stores them: one round trip per batch. A
// thread's chunks are a block apart: their (row, chunk) is stepped, not
// divided out.
template <typename T, int W, int L>
__device__ __forceinline__ void stage(const Stage& a, float* smem, int tid, int nthr) {
  using Chunk = typename std::conditional<W == 1, T, uint4>::type;
  const int cpr = W == 1 ? a.dq : a.d / W;  // chunks per row (W == 1 covers the pad)
  const int rows = a.nq + 2 * a.nk;
  const int step_r = nthr / cpr, step_c = nthr % cpr;
  const int k_base = a.q_rows * a.dq;  // smem offsets of K and V (Q at 0)
  const int v_base = k_base + a.nk * a.dk;
  int R = tid / cpr, cc = tid % cpr;
  while (R < rows) {
    // Every load is issued, from the tile's first row where the chunk is
    // padding, and nothing reads a loaded value before the last is issued.
    Chunk buf[L];
    int dst[L];
    bool zero[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int c = cc * W;
      const bool is_q = R < a.nq, is_k = !is_q && R < a.nq + a.nk;
      const int row = is_q ? R : is_k ? R - a.nq : R - a.nq - a.nk;
      const T* src = static_cast<const T*>(is_q ? a.q : is_k ? a.k : a.v);
      const long long ss = is_q ? a.qss : is_k ? a.kss : a.vss;
      const bool real = R < rows && row < (is_q ? a.q_valid : a.k_valid) && c < a.d;
      buf[u] = *reinterpret_cast<const Chunk*>(src + (real ? row * ss + c : 0));
      zero[u] = !real;
      dst[u] = R < rows ? (is_q ? 0 : is_k ? k_base : v_base) + row * (is_k ? a.dk : a.dq) + c
                        : -1;
      cc += step_c;
      R += step_r;
      if (cc >= cpr) {
        cc -= cpr;
        ++R;
      }
    }
#pragma unroll
    for (int u = 0; u < L; ++u) {
      if (dst[u] >= 0) {
        const float mul = dst[u] < k_base ? a.scale : 1.f;
        if constexpr (W == 1)
          smem[dst[u]] = zero[u] ? 0.f : to_float(buf[u]) * mul;
        else
          store_chunk<T>(smem + dst[u], zero[u] ? uint4{0, 0, 0, 0} : buf[u], mul);
      }
    }
  }
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// K rows are an odd number of 16-byte units: 8 lanes reading 8 rows'
// float4s at one column hit 8 different bank groups.
__host__ __device__ constexpr int k_stride(int dq) { return (dq / 4) % 2 ? dq : dq + 4; }

// Picks component r (0..3) of a per-row register array without local memory.
__device__ __forceinline__ float pick(const float (&x)[ROWS_PER_WARP], int r) {
  return r == 0 ? x[0] : r == 1 ? x[1] : r == 2 ? x[2] : x[3];
}

// KPL = keys a lane scores (the key tile is 32 * KPL). The PV product runs
// over 4-column chunks of the warp's 4 rows: with WIDE false (d <= 64) a
// lane owns row lane % 4 and chunks lane / 4 + 8 t, so at d = 8 the 8
// (row, chunk) items of a warp take 8 lanes; with WIDE true (d > 64) a
// lane owns chunks lane + 32 t of all 4 rows, so one V read feeds 4 rows.
// NI chunks a lane.
template <typename T, int KPL, int NI, bool WIDE>
__global__ void __launch_bounds__(SLICE_THREADS * MAX_SLICES)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int h, int s, int d, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, bool vec) {
  constexpr int BLOCK_K = 32 * KPL;
  constexpr int RL = WIDE ? ROWS_PER_WARP : 1;  // rows a lane owns in PV
  extern __shared__ __align__(16) float smem[];
  const int dq = round4(d);
  const int dk = k_stride(dq);
  const int nk = round4(min(s, BLOCK_K));
  const int nthr = blockDim.x;              // SLICE_THREADS a slice
  const int rows = nthr / 32 * ROWS_PER_WARP;  // the block's query rows
  float* q_s = smem;              // rows x dq, pre-scaled
  float* k_s = q_s + rows * dq;   // nk x dk
  float* v_s = k_s + nk * dk;     // nk x dq
  float* p_s = v_s + nk * dq;     // rows x BLOCK_K, each warp's 4 rows its own

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh % h;
  const int q0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * ROWS_PER_WARP;  // this warp's first row in the block

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + hi * ks.h;
  const T* vb = v + bi * vs.b + hi * vs.h;
  T* ob = out + bi * os.b + hi * os.h;

  // PV ownership. Chunks past d read chunk 0 and are not stored.
  const int pr = WIDE ? 0 : lane % ROWS_PER_WARP;
  int chunk[NI];
#pragma unroll
  for (int t = 0; t < NI; ++t) {
    chunk[t] = WIDE ? lane + 32 * t : lane / ROWS_PER_WARP + 8 * t;
    if (4 * chunk[t] >= dq) chunk[t] = 0;
  }

  float m_run[ROWS_PER_WARP], l_run[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  float acc[RL][NI][4];
#pragma unroll
  for (int rl = 0; rl < RL; ++rl)
#pragma unroll
    for (int t = 0; t < NI; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[rl][t][u] = 0.f;

  for (int k0 = 0; k0 < s; k0 += BLOCK_K) {
    const int kn = min(BLOCK_K, s - k0);  // real keys in this tile (>= 1)
    // This lane's mask bytes, in flight with the tile's loads (rows past s
    // and slots past the tile read a real byte and are not used).
    uint8_t mbyte[ROWS_PER_WARP][KPL];
    if (mask != nullptr) {
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const long long qi = min(q0 + row0 + r, s - 1);
#pragma unroll
        for (int i = 0; i < KPL; ++i)
          mbyte[r][i] = mask[qi * s + k0 + min(lane + 32 * i, kn - 1)];
      }
    }
    if (k0 > 0) __syncthreads();  // every warp's PV is done with this K and V
    Stage st{qb + q0 * qs.s, kb + k0 * ks.s, vb + k0 * vs.s, qs.s, ks.s, vs.s,
             k0 == 0 ? rows : 0, min(rows, s - q0), rows, nk, kn, d, dq, dk, scale};
    if (vec)
      stage<T, (int)(16 / sizeof(T)), 8>(st, smem, tid, nthr);
    else
      stage<T, 1, 16>(st, smem, tid, nthr);
    __syncthreads();

    // Scores: this warp's 4 rows against this lane's KPL keys, 4 columns
    // a step (Q's float4s are broadcasts). Slots past the tile read its
    // last key and are set to -inf below.
    float dot[ROWS_PER_WARP][KPL];
    const float* krow[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      krow[i] = k_s + min(lane + 32 * i, kn - 1) * dk;
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) dot[r][i] = 0.f;
    }
    const float* qw = q_s + row0 * dq;
#pragma unroll 2
    for (int c = 0; c < dq; c += 4) {
      float4 qv[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qw + r * dq + c);
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(krow[i] + c);
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          float a = fmaf(qv[r].x, kv.x, dot[r][i]);
          a = fmaf(qv[r].y, kv.y, a);
          a = fmaf(qv[r].z, kv.z, a);
          dot[r][i] = fmaf(qv[r].w, kv.w, a);
        }
      }
    }
    // Online softmax of the 4 rows side by side; every tile holds a real
    // key, so the new max is finite.
    float mx[ROWS_PER_WARP], sum[ROWS_PER_WARP], alpha[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const bool keep = mask == nullptr || mbyte[r][i] != 0;
        dot[r][i] = lane + 32 * i < kn ? (keep ? dot[r][i] : MASK_FILL) : -INFINITY;
        mx[r] = fmaxf(mx[r], dot[r][i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      sum[r] = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float p = expf(dot[r][i] - m_new);
        p_s[(row0 + r) * BLOCK_K + lane + 32 * i] = p;
        sum[r] += p;
      }
      alpha[r] = expf(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
    __syncwarp();  // this warp's P rows are written

    // acc = alpha * acc + P V for this lane's rows and chunks, four keys a
    // step (V rows and P slots past the tile are 0).
#pragma unroll
    for (int rl = 0; rl < RL; ++rl) {
      const float a = WIDE ? alpha[rl] : pick(alpha, pr);
#pragma unroll
      for (int t = 0; t < NI; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[rl][t][u] *= a;
    }
    const float* prow = p_s + (row0 + pr) * BLOCK_K;
    for (int j = 0; j < kn; j += 4) {
      float4 p[RL];
#pragma unroll
      for (int rl = 0; rl < RL; ++rl)
        p[rl] = *reinterpret_cast<const float4*>(prow + rl * BLOCK_K + j);
#pragma unroll
      for (int t = 0; t < NI; ++t) {
        const float* vc = v_s + j * dq + 4 * chunk[t];
        const float4 v0 = *reinterpret_cast<const float4*>(vc);
        const float4 v1 = *reinterpret_cast<const float4*>(vc + dq);
        const float4 v2 = *reinterpret_cast<const float4*>(vc + 2 * dq);
        const float4 v3 = *reinterpret_cast<const float4*>(vc + 3 * dq);
#pragma unroll
        for (int rl = 0; rl < RL; ++rl) {
          float* o = acc[rl][t];
          const float4 pp = p[rl];
          o[0] = fmaf(pp.w, v3.x, fmaf(pp.z, v2.x, fmaf(pp.y, v1.x, fmaf(pp.x, v0.x, o[0]))));
          o[1] = fmaf(pp.w, v3.y, fmaf(pp.z, v2.y, fmaf(pp.y, v1.y, fmaf(pp.x, v0.y, o[1]))));
          o[2] = fmaf(pp.w, v3.z, fmaf(pp.z, v2.z, fmaf(pp.y, v1.z, fmaf(pp.x, v0.z, o[2]))));
          o[3] = fmaf(pp.w, v3.w, fmaf(pp.z, v2.w, fmaf(pp.y, v1.w, fmaf(pp.x, v0.w, o[3]))));
        }
      }
    }
  }

#pragma unroll
  for (int rl = 0; rl < RL; ++rl) {
    const int qi = q0 + row0 + pr + rl;
    if (qi < s) {
      const float l = WIDE ? l_run[rl] : pick(l_run, pr);
#pragma unroll
      for (int t = 0; t < NI; ++t) {
        const int c = 4 * (WIDE ? lane + 32 * t : lane / ROWS_PER_WARP + 8 * t);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < d) from_float(ob + qi * os.s + c + u, acc[rl][t][u] / l);
      }
    }
  }
}

__host__ __device__ constexpr size_t smem_bytes(int d, int nk, int block_k, int slices) {
  return sizeof(float) * (size_t)(slices * SLICE * (round4(d) + block_k) +
                                  nk * (k_stride(round4(d)) + round4(d)));
}

// Streaming multiprocessors of the current device (read once a process).
int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 1;
    return n;
  }();
  return count;
}

template <typename T, int KPL, int NI, bool WIDE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int b, int s, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, bool vec, cudaStream_t stream) {
  constexpr int BLOCK_K = 32 * KPL;
  // Once per instance: its largest block (d + 4 bounds every K stride).
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_attention_kernel<T, KPL, NI, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes((WIDE ? 128 : 32) * NI + 4, BLOCK_K, BLOCK_K, MAX_SLICES));
  if (attr != cudaSuccess) return attr;
  // Slices a block: up to MAX_SLICES, as many as keep one block for each
  // SM, so that each (batch, head)'s K and V are staged as few times as the
  // card's width allows (one slice at `tiny`'s 4 slices of work).
  const int slices = (s + SLICE - 1) / SLICE;
  const int per_block = std::min(
      {MAX_SLICES, slices, std::max(1, (b * h * slices + sm_count() - 1) / sm_count())});
  dim3 grid(b * h, (slices + per_block - 1) / per_block);
  const size_t smem = smem_bytes(d, round4(std::min(s, BLOCK_K)), BLOCK_K, per_block);
  fused_attention_kernel<T, KPL, NI, WIDE><<<grid, SLICE_THREADS * per_block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), h, s, d, qs, ks, vs, os, scale,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
                     int b, int s, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, cudaStream_t st) {
  // 16-byte chunks where every row of q, k and v starts 16-byte aligned
  // and d fills whole chunks.
  constexpr long long W = 16 / sizeof(T);
  const unsigned long long ptrs = reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const long long strides = qs.b | qs.s | qs.h | ks.b | ks.s | ks.h | vs.b | vs.s | vs.h;
  const bool vec = d % W == 0 && ptrs % 16 == 0 && strides % W == 0;
  // Keys a lane: one pass up to 128 keys at d <= 64, 96 at d <= 128, 32
  // above, so that K and V of a tile stay within 100 KB of shared memory.
  const int kpl = std::min((s + 31) / 32, d <= 64 ? 4 : d <= 128 ? 3 : 1);
#define RT1_LAUNCH(KPL, NI, WIDE) \
  launch<T, KPL, NI, WIDE>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, vec, st)
  if (d > 128) return RT1_LAUNCH(1, 2, true);
  if (d > 64)
    return kpl == 1 ? RT1_LAUNCH(1, 1, true) : kpl == 2 ? RT1_LAUNCH(2, 1, true)
                                               : RT1_LAUNCH(3, 1, true);
  switch (kpl) {
    case 1: return RT1_LAUNCH(1, 2, false);
    case 2: return RT1_LAUNCH(2, 2, false);
    case 3: return RT1_LAUNCH(3, 2, false);
    default: return RT1_LAUNCH(4, 2, false);
  }
#undef RT1_LAUNCH
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
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale,
                                        st);
  return (int)cudaErrorInvalidValue;
}
