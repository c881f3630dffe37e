// Fused masked attention for Hopper (sm_90a) on the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel `_attention_kernel` in
// rt1_tpu/parallel/flash_attention.py (wrapper `fused_attention`) for
// bfloat16 inputs. Per (batch, head) it computes what that kernel computes,
//
//   out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v
//
// with fp32 logits, an fp32 softmax and an fp32 PV product, and the result
// rounded to bf16. q, k, v and out are (b, s, h, d) bf16 read through their
// strides (rows 16-byte aligned, the last dim contiguous); d is a multiple
// of 16 up to 256; any s >= 1. The optional mask is a dense (s, s) uint8
// array shared by every (batch, head), its base 16-byte aligned. float32
// inputs, and bf16 inputs this kernel cannot take, go to the simple kernel
// in fused_attention.cu (the rule is `_variant` in
// rt1_tpu_torch/parallel/flash_attention.py): on the tensor cores an fp32
// product would be TF32, and the float32 path is the one held to the CPU.
//
// Bound at the serve shape (b = 8, s = 66, h = 8, d = 128, bf16): q, k, v
// and out are 4 * 8*66*8*128 * 2 B = 4.33 MB, 1.29 us at 3.35 TB/s; the two
// products are 4 * b*h*s*s*d = 0.143 GFLOP, 0.14 us at the bf16 tensor-core
// peak. So the function is bound by bytes and, at this size, by latency:
// every block's chain of copy, S, softmax, PV and store. PERF.md has the
// kernel's times and scripts/attention_timeline.py measures that chain.
//
// Design, against what held the simple kernel (fused_attention.cu) back:
//
// * Tensor cores. Both products are mma.sync.m16n8k16 bf16 with fp32
//   accumulate; fragments come from shared memory through ldmatrix (K
//   non-transposed as QK^T's B operand, V through ldmatrix.trans as PV's B
//   operand). The S accumulator becomes PV's A fragment in registers, as in
//   FlashAttention-2, so P never touches shared memory. Per k-step all K
//   fragments are loaded before the first mma, and per 16-key chunk a batch
//   of V fragments, so no mma waits on its own ldmatrix. wgmma is not used:
//   it works on 64-row tiles, s = 66 would leave a second tile 97 % empty,
//   and the products (0.14 us at peak) do not bound the function.
// * Numerics held to the JAX kernel. bf16 x bf16 products are exact in fp32
//   and summed in fp32; `scale` is applied to the fp32 logits (q is never
//   pre-scaled and rounded back to bf16). The softmax runs in base 2
//   (logits times log2 e, exp2), which changes p by about 1e-6 relative. P
//   stays fp32 through PV: it is split into hi = bf16(p) and
//   lo = bf16(p - hi), and both are multiplied against the same V fragment,
//   so P's error falls from 2^-9 to about 2^-17 relative (a single bf16 P,
//   as SDPA and the dense path use, is a different function). The lo
//   products double PV's mma count.
// * Asynchronous copies, one read of K/V per block. Q, K and V come in with
//   cp.async, 16 B a thread, in commit groups: Q and K of a key tile first,
//   V second, so QK^T and the softmax run while V is still in flight. Keys
//   are walked in tiles of BK rows through a two-stage ring with an fp32
//   online softmax. Every block copies with all WARPS (8) warps, since
//   a warp keeps only a few copies in flight; its first `slices` warps also
//   compute, 16 query rows each. One block of a (batch, head) loads its
//   K/V into shared memory once; more blocks of fewer warps each re-read
//   K/V from L2. The sweep in chip_smoke.py chose 3 slices at the serve
//   shape (the wrapper's TC_SLICES_PER_BLOCK): 2 blocks per (batch, head),
//   one compute warp per scheduler of the SM.
// * TMA bulk copies were tried in place of cp.async, one per 256-byte row:
//   they landed later (about 50 cycles each in the copy engine, measured
//   with scripts/attention_timeline.py). A tiled TMA copy would need a
//   tensor map encoded on the host for every call (q/k/v are new tensors in
//   every layer), on a host-bound path.
// * Shared rows are padded by 16 B (row stride D + 8 elements), so the 8
//   rows of one ldmatrix phase fall in 8 different 16-byte bank groups.
// * Rows past s and columns past d are zero-filled in shared memory by
//   cp.async's src-size operand, so P = 0 never meets uninitialised V.
//   Key positions past s get -inf, masked keys -1e9, and the running max
//   starts at -inf: a fully masked row is the mean of its s real value
//   rows, as the simple kernel and `dense_attention_reference` give.
// * The mask's rows are s bytes apart (66 at the serve shape, not 16-byte
//   aligned), so each tile's mask rows are copied as the aligned 16-byte
//   chunks that cover them, ahead of Q and K in the same group; a warp then
//   turns its 16 rows into bit words with one ballot per 32 keys, and each
//   thread tests its logits against those words. Reading the bytes per
//   logit, or from global memory behind the copies, cost more.
// * The output is staged through the warp's own Q rows in shared memory
//   and written 16 bytes a lane.
// * A light host path: the dynamic shared-memory attribute is set once per
//   template instance, not per launch.

#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// Built with -DRT1_ATTENTION_TIMELINE (scripts/attention_timeline.py, never
// by the wrapper), the kernel and its C entry take one more argument, a
// buffer of 16 int64 per warp: the %globaltimer at entry, then the SM's
// clock64 at entry, after issuing the first copies, when Q and K of the
// first tile have landed, after the first softmax, when its V has landed,
// after its PV product and at the end; slots 8-11 repeat the four stamps
// of one tile for the second tile, whose code runs warm.
#ifdef RT1_ATTENTION_TIMELINE
#define TIMELINE_PARAM , long long* __restrict__ timeline
#define TIMELINE_ARG , timeline
#define STAMP(i, value)                                                              \
  do {                                                                               \
    if (lane == 0)                                                                   \
      timeline[((blockIdx.y * gridDim.x + blockIdx.x) * WARPS + warp) * 16 + (i)] = \
          (long long)(value);                                                        \
  } while (0)
#else
#define TIMELINE_PARAM
#define TIMELINE_ARG
#define STAMP(i, value) \
  do {                  \
  } while (0)
#endif

namespace {

constexpr float MASK_FILL = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = MASK_FILL * LOG2E;
// Warps per block: every block copies with all of them, and its first
// `slices` (at most all of them) also compute, 16 query rows each.
constexpr int WARPS = 8;
constexpr int PAD = 8;  // bf16 elements of padding per shared row (16 B)

struct Strides {
  long long b, s, h;  // in elements; the d stride is 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the 16 B.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a * b for one m16n8k16 tile: bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values (x0 in the low half) as hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D: head dim padded to 64, 128 or 256 (runtime d <= D, d % 16 == 0).
// BK: keys per tile.
template <int D, int BK>
__global__ void __launch_bounds__(WARPS * 32)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                    __nv_bfloat16* __restrict__ out, int h, int s, int d, Strides qs,
                    Strides ks, Strides vs, Strides os, float scale,
                    int slices TIMELINE_PARAM) {
  constexpr int LD = D + PAD;          // shared row stride, elements
  constexpr int CH = D / 8;            // 16-byte chunks per row
  constexpr int NT = BK / 8;           // key n-tiles of S per tile
  constexpr int KC = BK / 16;          // 16-key chunks per tile (PV k-steps)
  constexpr int DK = D / 16;           // QK^T k-steps; PV pairs of d n-tiles
  constexpr int DT = D / 8;            // d n-tiles of O
  constexpr int VB = DK < 8 ? DK : 8;  // V fragments loaded ahead per batch
  constexpr int NW = BK / 32;          // 32-key mask words per row and tile
  constexpr int MPITCH = BK + 16;      // bytes per mask row in shared memory
  constexpr int MCH = MPITCH / 16;     // 16-byte chunks per mask row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int rows = slices * 16;       // query rows of the block
  const int q0 = blockIdx.y * rows;   // first query row of the block
  const int wq0 = q0 + warp * 16;     // first query row of this warp
  STAMP(0, global_ns());
  STAMP(1, clock64());
  const bool active = warp < slices && wq0 < s;  // warp-uniform
  const int s16 = (s + 15) & ~15;
  const int stage_rows = min(BK, s16);
  const int ntiles = (s + BK - 1) / BK;
  const int stages = ntiles > 1 ? 2 : 1;
  const float scale_log2 = scale * LOG2E;  // softmax in base 2: exp(x) = 2^(x log2 e)

  // Shared memory: Q (rows x LD), the K/V ring (stage st: K then V, each
  // stage_rows x LD), then the mask ring (stage st: rows x MPITCH bytes).
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const kv_s = q_s + rows * LD;
  uint8_t* const m_s = reinterpret_cast<uint8_t*>(kv_s + stages * 2 * stage_rows * LD);
  const __nv_bfloat16* const qb = q + bi * qs.b + hi * qs.h;
  const __nv_bfloat16* const kb = k + bi * ks.b + hi * ks.h;
  const __nv_bfloat16* const vb = v + bi * vs.b + hi * vs.h;
  __nv_bfloat16* const ob = out + bi * os.b + hi * os.h;

  // Row copies by every warp of the block: each thread owns one 16-byte
  // column and every (blockDim / CH)-th row, a few instructions per copy.
  // Rows past s (up to the next multiple of 16) and columns past d are
  // zero-filled, so the mma never read uninitialised shared memory.
  const int ccol = threadIdx.x % CH;
  const int crow = threadIdx.x / CH;
  const int rstep = blockDim.x / CH;
  const bool col_ok = ccol * 8 < d;
  auto copy_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long rs, int r0,
                       int nrows) {
#pragma unroll 4
    for (int r = crow; r < nrows; r += rstep) {
      const int row = r0 + r;
      const bool ok = col_ok && row < s;
      cp_async16(smem_u32(dst + r * LD + ccol * 8), ok ? src + row * rs + ccol * 8 : src,
                 ok ? 16 : 0);
    }
  };
  // The mask's rows of a tile: the segment [row * s + k0, + cols) of each
  // block row, copied as the 16-byte aligned chunks that cover it (the
  // mask's base is 16-byte aligned; the last chunk stops at the mask's
  // end). A row's byte for key k0 + j then sits at (row * s + k0) % 16 + j.
  // The mask's rows are s bytes apart (66 at the serve shape), so they
  // cannot be copied row by row in 16-byte pieces.
  const long long mask_bytes = (long long)s * s;
  auto copy_mask = [&](int t) {
    const int k0 = t * BK;
    const int cols = min(BK, s - k0);
    uint8_t* const dst = m_s + (t & 1) * rows * MPITCH;
    for (int i = threadIdx.x; i < rows * MCH; i += blockDim.x) {
      const int r = i / MCH, c = i - r * MCH;
      const long long seg = (long long)(q0 + r) * s + k0;
      const long long off = (seg & ~15LL) + 16 * c;
      const int nbytes = q0 + r < s && off < seg + cols ? (int)min(16LL, mask_bytes - off) : 0;
      cp_async16(smem_u32(dst + r * MPITCH + 16 * c), nbytes ? mask + off : mask, nbytes);
    }
  };
  // Tile t's K (after its mask rows) or V into ring stage t & 1: one commit
  // group each, empty when t >= ntiles so that the group count stays fixed.
  auto load_tile = [&](int t, bool is_v) {
    if (t < ntiles) {
      const int k0 = t * BK;
      if (!is_v && mask != nullptr && t > 0) copy_mask(t);  // tile 0's goes first
      __nv_bfloat16* dst = kv_s + (2 * (t & 1) + (is_v ? 1 : 0)) * stage_rows * LD;
      copy_rows(dst, is_v ? vb : kb, is_v ? vs.s : ks.s, k0, min(BK, s16 - k0));
    }
    cp_async_commit();
  };

  // Groups: {mask 0, Q, K0}, {V0}, {mask 1, K1}, {V1}; iteration t waits on
  // K_t with 3 younger groups outstanding and on V_t with 2.
  if (mask != nullptr) copy_mask(0);
  copy_rows(q_s, qb, qs.s, q0, min(rows, s16 - q0));
  load_tile(0, false);
  load_tile(0, true);
  load_tile(1, false);
  load_tile(1, true);
  STAMP(2, clock64());

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows a, b (base-2 logits)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the running sums

  // ldmatrix lane addresses: Q as the A operand; K (non-transposed) and V
  // (transposed) as B operands, per 16-key chunk c at byte offset c * 16 * LD * 2.
  const uint32_t q_addr =
      smem_u32(q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const int kc_n = min(KC, (s - k0 + 15) >> 4);  // chunks holding a real key
    const __nv_bfloat16* const k_s = kv_s + 2 * (t & 1) * stage_rows * LD;
    const uint32_t k_addr = smem_u32(k_s + k_lane);
    const uint32_t v_addr = smem_u32(k_s + stage_rows * LD + v_lane);

    cp_async_wait<3>();  // Q, K_t and its mask rows have landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's
    if (t < 2) STAMP(t ? 8 : 3, clock64());

    // Mask bits of this warp's 16 rows: lane l reads key 32 w + l of each
    // staged row (32 consecutive bytes; all of them before the first
    // ballot), one ballot per (row, w) makes the row's 32-key word, and each
    // thread keeps the words of its rows g and g + 8.
    uint32_t bits_a[NW], bits_b[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) bits_a[w] = bits_b[w] = 0xffffffffu;
    if (mask != nullptr && active) {
      const uint8_t* const mw = m_s + (t & 1) * rows * MPITCH + warp * 16 * MPITCH + lane;
      uint32_t bytes[16][NW];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int head = (int)(((long long)(wq0 + r) * s + k0) & 15);
#pragma unroll
        for (int w = 0; w < NW; ++w)
          bytes[r][w] = k0 + 32 * w + lane < s ? mw[r * MPITCH + head + 32 * w] : 0u;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint32_t word = __ballot_sync(0xffffffffu, bytes[r][w] != 0u);
          if (r == g) bits_a[w] = word;
          if (r == g + 8) bits_b[w] = word;
        }
      }
    }

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if (active) {
      // S = Q K^T over this tile's real chunks. Per k-step, every chunk's K
      // fragment is loaded before the first mma, and the next Q fragment
      // is loaded a step ahead, so shared-memory latency is paid once a step.
      uint32_t a[2][4];
      ldmatrix_x4(a[0], q_addr);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk + 1 < DK) ldmatrix_x4(a[(kk + 1) & 1], q_addr + (kk + 1) * 32);
        uint32_t b[KC][4];
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < kc_n) ldmatrix_x4(b[c], k_addr + (c * 16 * LD + kk * 16) * 2);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (c < kc_n) {
            mma_bf16(sc[2 * c], a[kk & 1], b[c][0], b[c][1]);
            mma_bf16(sc[2 * c + 1], a[kk & 1], b[c][2], b[c][3]);
          }
        }
      }

      // fp32 logits in base 2: scale, mask (-1e9), keys past s (-inf), over
      // every n-tile of the tile (chunks past kc_n hold only keys past s).
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = 8 * j + 2 * t4 + e;  // key within the tile
          const int bit = 8 * (j & 3) + 2 * t4 + e;
          float la = (bits_a[j >> 2] >> bit) & 1u ? sc[j][e] * scale_log2 : MASK_FILL_LOG2;
          float lb = (bits_b[j >> 2] >> bit) & 1u ? sc[j][2 + e] * scale_log2 : MASK_FILL_LOG2;
          if (k0 + kl >= s) la = lb = -INFINITY;
          sc[j][e] = la;
          sc[j][2 + e] = lb;
          mx_a = fmaxf(mx_a, la);
          mx_b = fmaxf(mx_b, lb);
        }
      }
      // Every tile holds a real key, so the new maxima are finite.
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float alpha_a = exp2f(m_a - mn_a);  // 0 on the first tile
      const float alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[j][e] = exp2f(sc[j][e] - mn_a);
          sc[j][2 + e] = exp2f(sc[j][2 + e] - mn_b);
          sum_a += sc[j][e];
          sum_b += sc[j][2 + e];
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][0] *= alpha_a;
          o[j][1] *= alpha_a;
          o[j][2] *= alpha_b;
          o[j][3] *= alpha_b;
        }
      }
    }

    if (t < 2) STAMP(t ? 9 : 4, clock64());
    cp_async_wait<2>();  // V_t has landed
    __syncthreads();
    if (t < 2) STAMP(t ? 10 : 5, clock64());

    if (active) {
      // O += P V with P = hi + lo against the same V fragments: a batch of
      // V fragments is loaded first, then all hi products, then all lo
      // products, so no mma waits on the one before it.
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (c < kc_n) {
          uint32_t ph[4], pl[4];
          split_bf16x2(sc[2 * c][0], sc[2 * c][1], ph[0], pl[0]);
          split_bf16x2(sc[2 * c][2], sc[2 * c][3], ph[1], pl[1]);
          split_bf16x2(sc[2 * c + 1][0], sc[2 * c + 1][1], ph[2], pl[2]);
          split_bf16x2(sc[2 * c + 1][2], sc[2 * c + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int d0 = 0; d0 < DK; d0 += VB) {
            uint32_t b[VB][4];
#pragma unroll
            for (int i = 0; i < VB; ++i)
              ldmatrix_x4_trans(b[i], v_addr + (c * 16 * LD + (d0 + i) * 16) * 2);
#pragma unroll
            for (int i = 0; i < VB; ++i) {
              mma_bf16(o[2 * (d0 + i)], ph, b[i][0], b[i][1]);
              mma_bf16(o[2 * (d0 + i) + 1], ph, b[i][2], b[i][3]);
            }
#pragma unroll
            for (int i = 0; i < VB; ++i) {
              mma_bf16(o[2 * (d0 + i)], pl, b[i][0], b[i][1]);
              mma_bf16(o[2 * (d0 + i) + 1], pl, b[i][2], b[i][3]);
            }
          }
        }
      }
    }

    if (t < 2) STAMP(t ? 11 : 6, clock64());
    if (t + 2 < ntiles) __syncthreads();  // stage t & 1 is free for tile t + 2
    load_tile(t + 2, false);
    load_tile(t + 2, true);
  }
  cp_async_wait<0>();

  if (active) {
    // Normalise, stage the warp's 16 rows in its own Q rows (no other warp
    // reads them), then write 16 bytes a lane.
    const float inv_a = 1.f / quad_sum(l_a);
    const float inv_b = 1.f / quad_sum(l_b);
    __nv_bfloat16* const o_s = q_s + warp * 16 * LD;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o_s + g * LD + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8) * LD + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      if (wq0 + r < s && c * 8 < d)
        *reinterpret_cast<uint4*>(ob + (wq0 + r) * os.s + c * 8) =
            *reinterpret_cast<const uint4*>(o_s + r * LD + c * 8);
    }
  }
  STAMP(7, clock64());
}

template <int D, int BK>
size_t smem_bytes(int slices, int s, bool masked) {
  const int stage_rows = std::min(BK, (s + 15) & ~15);
  const int stages = s > BK ? 2 : 1;
  const size_t mask_ring = masked ? (size_t)stages * slices * 16 * (BK + 16) : 0;
  return sizeof(__nv_bfloat16) * (size_t)(slices * 16 + stages * 2 * stage_rows) * (D + PAD) +
         mask_ring;
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int b, int s, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int slices, cudaStream_t stream TIMELINE_PARAM) {
  // Once per instance, for the largest block it can be given.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_tc_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<D, BK>(WARPS, 2 * BK, true));
  if (attr != cudaSuccess) return attr;
  const int chunks = (s + 15) / 16;
  slices = std::min(slices, chunks);
  dim3 grid(b * h, (chunks + slices - 1) / slices);
  attention_tc_kernel<D, BK>
      <<<grid, WARPS * 32, smem_bytes<D, BK>(slices, s, mask != nullptr), stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
          static_cast<__nv_bfloat16*>(out), h, s, d, qs, ks, vs, os, scale,
          slices TIMELINE_ARG);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Strides are in elements; every row, and the mask's base, must
// start 16-byte aligned and d must be a multiple of 16 in [16, 256] (the
// wrapper's `_variant` checks these). `slices` (1..8) is the number of
// 16-row query slices per block. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int rt1_fused_attention_tc_fwd(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int b, int s, int h,
                                          int d, long long q_sb, long long q_ss, long long q_sh,
                                          long long k_sb, long long k_ss, long long k_sh,
                                          long long v_sb, long long v_ss, long long v_sh,
                                          long long o_sb, long long o_ss, long long o_sh,
                                          float scale, int slices,
                                          void* stream TIMELINE_PARAM) {
  if (b < 1 || s < 1 || h < 1 || d < 16 || d > 256 || d % 16 != 0 || slices < 1 ||
      slices > WARPS)
    return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return (int)launch<64, 128>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, slices,
                                 st TIMELINE_ARG);
  if (d <= 128)
    return (int)launch<128, 128>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, slices,
                                 st TIMELINE_ARG);
  return (int)launch<256, 64>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, slices,
                                 st TIMELINE_ARG);
}
