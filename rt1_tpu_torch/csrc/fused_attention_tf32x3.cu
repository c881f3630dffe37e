// Fused masked attention for Hopper (sm_90a) in float32 on the tensor cores,
// held to fp32 by 3xTF32.
//
// Replaces the Pallas TPU kernel `_attention_kernel` in
// rt1_tpu/parallel/flash_attention.py (wrapper `fused_attention`) for
// float32 inputs. Per (batch, head) it computes what that kernel computes,
//
//   out = softmax(where(mask != 0, (q * scale) k^T, -1e9)) v
//
// with fp32-grade logits, an fp32 softmax and an fp32-grade PV product,
// and writes float32. q, k, v and out are (b, s, h, d) float32 read through
// their strides (rows 16-byte aligned, the last dim contiguous); d is a
// multiple of 8 up to 256; any s >= 1. The optional mask is a dense (s, s)
// uint8 array shared by every (batch, head), its base 16-byte aligned.
// float32 calls this kernel cannot take go to the simple kernel in
// fused_attention.cu (the rule is `_variant` in
// rt1_tpu_torch/parallel/flash_attention.py).
//
// Bound at the serve shape (b = 8, s = 66, h = 8, d = 128, float32): q, k,
// v and out are 4 * 8*66*8*128 * 4 B = 8.65 MB, 2.58 us at 3.35 TB/s; the
// two products are 4 * b*h*s*s*d = 0.143 GFLOP, 2.1 us at the 67 TFLOP/s
// of fp32 outside the tensor cores and 0.9 us at TF32's 495 TFLOP/s even
// when tripled. So the function is bound by bytes and, at this size, by
// the latency of every block's chain of copy, S, softmax, PV and store.
// PERF.md has the kernel's times.
//
// Design:
//
// * 3xTF32 on the tensor cores. One TF32 product keeps ~11 bits of each
//   operand, so a single one is not the fp32 function. Every fp32 operand
//   x is split as big = tf32(x) and small = tf32(x - big), rounded to
//   nearest as cvt.rna.tf32.f32 rounds (`tf32_rna`; the hardware would
//   otherwise truncate the low 13 bits of an unconverted register), and
//   each product a b is mma.sync.m16n8k8 tf32 with fp32 accumulate on
//   a_small b_big, then a_big b_small, then a_big b_big: the dropped
//   a_small b_small is ~2^-22 of the product, so the error is fp32-grade
//   (CUTLASS's "fast accurate" fp32 GEMM is the same scheme). It triples
//   the mma count; the three products run as passes over independent
//   tiles, so no mma waits on its predecessor. `scale` is applied
//   to the fp32 logits (the JAX kernel scales q first: the two differ by
//   rounding only), and the softmax runs in base 2 (exp2 of logits times
//   log2 e).
// * P stays in fp32 registers and is split like any other operand. The
//   m16n8k8 C fragment holds keys 2t, 2t+1 of an 8-key n-tile where the A
//   fragment wants k = t, t+4; instead of shuffling, k-slot t stands for
//   key 2t and k-slot t+4 for key 2t+1, and V's B fragment is read from
//   the same two rows. Normalised by the fp32 row sum at the end.
// * The work split of the bf16 kernel (fused_attention_tc.cu): a block is
//   one (batch, head) and `slices` 16-row query slices, one compute warp
//   each, in WARPS (8) warps. At s = 66 (80 keys padded) and d = 128 the
//   whole K and V (80 KB) sit in shared memory at once, read from device
//   memory once per block, in one 80-key tile; longer sequences walk key
//   tiles through a two-stage ring with an online softmax.
// * Small code, few registers. The k-step loop of S and the key loop of PV
//   stay rolled (P's n-tile is picked out of registers by selects): the
//   first version, fully unrolled, was slower (PERF.md).
//   Near the 255-register limit ptxas reuses the mma operands' registers
//   and the mma run one after another, so the tile is sized to the
//   sequence (the C entry) and no mma sits behind a per-tile branch.
// * Copies: cp.async, 16 B a thread, in commit groups: the mask rows, Q and
//   K of a tile first (by every warp), V second (by the warps that do not
//   compute, where there are enough), so S and the softmax run while V is
//   in flight. Dynamic shared memory above 48 KB (the attribute is set
//   once per template instance to the card's opt-in limit).
// * Fragments without bank conflicts. Shared rows are D + 4 floats: one
//   row is then an odd number of 16-byte units, so the 8 rows of an
//   ldmatrix phase fall in 8 different bank groups. ldmatrix (b16, no
//   .trans) on 32-bit words yields exactly the tf32 A fragment of
//   row-major Q and the B fragment of K stored [key][d]. V's B fragment
//   (rows 2t, 2t+1, column g) is read with scalar loads; with the 4-float
//   pad the rows one load touches (0, 2, 4, 6 or 1, 3, 5, 7) start 8 banks
//   apart, so the 32 lanes hit 32 banks (a pad of 8 would give 2-way
//   conflicts).
// * Masks and padding as in the bf16 kernel: the mask's rows of a tile are
//   staged as the aligned 16-byte chunks that cover them and turned into
//   bit words by one ballot per (row, 32 keys); masked logits are -1e9,
//   keys past s -inf, the running max starts at -inf, so a fully masked
//   row is the mean of its s real value rows, as `dense_attention_reference`
//   gives. Rows past s and columns past d are zero-filled by cp.async's
//   src-size operand; k-steps past d are skipped, and d n-tiles past d
//   multiply zeros and are not written.
// * The output is written straight from the C fragments through out's
//   strides, 8 bytes a lane.

#include <algorithm>

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Built with -DRT1_ATTENTION_TIMELINE (scripts/attention_timeline.py, never
// by the wrapper), the kernel and its C entry take one more argument, a
// buffer of 16 int64 per warp, stamped at the same points as the bf16
// kernel's (see fused_attention_tc.cu).
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
// Warps per block: every block copies Q and K with all of them, and its
// first `slices` (at most all of them) also compute, 16 query rows each.
constexpr int WARPS = 8;
constexpr int PAD = 4;  // floats of padding per shared row (16 B)

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

// Four 8x4 tiles of 32-bit words (8 rows of 16 bytes each): lane l gets
// word (l / 4, l % 4) of tile i in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// x rounded to tf32 (10 mantissa bits), nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives for finite x, as two integer operations (add half
// the weight of the 13 dropped bits to the magnitude, then clear them).
// ptxas emits cvt.rna.tf32.f32 as this rounding plus a finiteness test and
// a select per value, which cost the kernel a sixth of its time at the
// serve shape (PERF.md); the inputs' non-finite values reach the output
// as non-finite values either way.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small in tf32 (x - big is exact in fp32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void split_tf32(const uint32_t (&x)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// c += a * b for one m16n8k8 tile: tf32 inputs, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S += Q K^T over one key tile in 3xTF32, one k-step of 8 d-columns an
// iteration of a rolled loop (k-steps past d hold zeros and are not run). Per k-step every
// chunk's K fragment is loaded before the first mma and the next Q
// fragment a step ahead; the three products run as three passes over the
// n-tiles (a_small b_big, a_big b_small, a_big b_big), so no mma waits on
// the one before it. K's split is recomputed per pass (two integer
// operations) rather than held in 2 x 4 KC registers. FULL: every chunk
// of the tile holds a real key, so no mma sits behind a branch (a branch
// around an mma costs a warp resynchronisation); the n-tile past s in the
// last chunk, if any, is computed from zero-filled rows and ignored.
template <int LD, int KC, int NT, bool FULL>
__device__ __forceinline__ void s_product(float (&sc)[NT][4], uint32_t q_addr, uint32_t k_addr,
                                          int nk, int kc_n, int nt_n) {
  uint32_t a[4], a_next[4];
  ldmatrix_x4(a, q_addr);
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    // The next k-step's Q fragment; past d it reads the row pad or the
    // next row, still inside the block's shared memory, and is not used.
    ldmatrix_x4(a_next, q_addr + (kk + 1) * 32);
    uint32_t b[KC][4];
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (FULL || c < kc_n) ldmatrix_x4(b[c], k_addr + (c * 16 * LD + kk * 8) * 4);
    uint32_t a_big[4], a_small[4];
    split_tf32(a, a_big, a_small);
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (FULL || c < kc_n) {
          uint32_t bk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = __uint_as_float(b[c][i]);
            const uint32_t big = tf32_rna(x);
            bk[i] = pass == 1 ? tf32_rna(x - __uint_as_float(big)) : big;
          }
          const uint32_t(&ak)[4] = pass == 0 ? a_small : a_big;
          mma_tf32(sc[2 * c], ak, bk[0], bk[1]);
          if (FULL || 2 * c + 1 < nt_n) mma_tf32(sc[2 * c + 1], ak, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_next[i];
  }
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

// D: head dim padded to 64, 128 or 256 (runtime d <= D, d % 8 == 0).
// BK: keys per tile (a multiple of 16).
template <int D, int BK>
__global__ void __launch_bounds__(WARPS * 32)
attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const uint8_t* __restrict__ mask,
                        float* __restrict__ out, int h, int s, int d, Strides qs, Strides ks,
                        Strides vs, Strides os, float scale, int slices TIMELINE_PARAM) {
  constexpr int LD = D + PAD;          // shared row stride, floats
  constexpr int CH = D / 4;            // 16-byte chunks per row
  constexpr int NT = BK / 8;           // 8-key n-tiles of S per tile (PV k-steps)
  constexpr int KC = BK / 16;          // 16-key chunks per tile (one K ldmatrix each)
  constexpr int DK = D / 8;            // QK^T k-steps; d n-tiles of O
  constexpr int VB = DK < 8 ? DK : 8;  // d n-tiles of V fragments loaded per batch
  constexpr int NW = (BK + 31) / 32;   // 32-key mask words per row and tile
  constexpr int MPITCH = BK + 16;      // bytes per mask row in shared memory
  constexpr int MCH = MPITCH / 16;     // 16-byte chunks per mask row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8); V's fragment column
  const int t4 = lane & 3;  // fragment column pair; V's fragment rows 2 t4, 2 t4 + 1
  const int bi = blockIdx.x / h;
  const int hi = blockIdx.x % h;
  const int rows = slices * 16;      // query rows of the block
  const int q0 = blockIdx.y * rows;  // first query row of the block
  const int wq0 = q0 + warp * 16;    // first query row of this warp
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
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const kv_s = q_s + rows * LD;
  uint8_t* const m_s = reinterpret_cast<uint8_t*>(kv_s + stages * 2 * stage_rows * LD);
  const float* const qb = q + bi * qs.b + hi * qs.h;
  const float* const kb = k + bi * ks.b + hi * ks.h;
  const float* const vb = v + bi * vs.b + hi * vs.h;
  float* const ob = out + bi * os.b + hi * os.h;

  // Row copies by threads [first, blockDim) of the block: each owns one
  // 16-byte column and every (n / CH)-th row (n of them, a multiple of
  // CH). Rows past s (up to the next multiple of 16) and columns past d are
  // zero-filled. Q and K are copied by every warp; V, which is needed only
  // after S and the softmax, by the warps that do not compute where there
  // are enough of them, so that the compute warps start S sooner.
  const int v_first = (WARPS - slices) * 32 >= 2 * CH ? slices * 32 : 0;
  auto copy_rows = [&](float* dst, const float* src, long long rs, int r0, int nrows,
                       int first) {
    const int rstep = (blockDim.x - first) / CH;
    const int tid = threadIdx.x - first;
    if (tid < 0 || tid >= rstep * CH) return;
    const int ccol = tid % CH;
    const bool col_ok = ccol * 4 < d;
#pragma unroll 4
    for (int r = tid / CH; r < nrows; r += rstep) {
      const int row = r0 + r;
      const bool ok = col_ok && row < s;
      cp_async16(smem_u32(dst + r * LD + ccol * 4), ok ? src + row * rs + ccol * 4 : src,
                 ok ? 16 : 0);
    }
  };
  // The mask's rows of a tile: the segment [row * s + k0, + cols) of each
  // block row, copied as the 16-byte aligned chunks that cover it (the
  // mask's base is 16-byte aligned; the last chunk stops at the mask's
  // end). A row's byte for key k0 + j then sits at (row * s + k0) % 16 + j.
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
      float* dst = kv_s + (2 * (t & 1) + (is_v ? 1 : 0)) * stage_rows * LD;
      copy_rows(dst, is_v ? vb : kb, is_v ? vs.s : ks.s, k0, min(BK, s16 - k0),
                is_v ? v_first : 0);
    }
    cp_async_commit();
  };

  // Groups: {mask 0, Q, K0}, {V0}, {mask 1, K1}, {V1}; iteration t waits on
  // K_t with 3 younger groups outstanding and on V_t with 2.
  if (mask != nullptr) copy_mask(0);
  copy_rows(q_s, qb, qs.s, q0, min(rows, s16 - q0), 0);
  load_tile(0, false);
  load_tile(0, true);
  load_tile(1, false);
  load_tile(1, true);
  STAMP(2, clock64());

  float o[DK][4];
#pragma unroll
  for (int j = 0; j < DK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max of rows a, b (base-2 logits)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the running sums

  // ldmatrix lane addresses (bytes): Q as the A operand (tiles: rows 0-7
  // and 8-15 at words 0-3, then the same at words 4-7), K as the B operand
  // (tiles: keys 0-7 at words 0-3 and 4-7, then keys 8-15), per k-step of
  // 8 words at +32 bytes and per 16-key chunk at +16 LD words.
  const uint32_t q_addr =
      smem_u32(q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4);
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
  // V's B fragment: rows 2 t4 and 2 t4 + 1 of an 8-key n-tile, column g of a d n-tile.
  const int v_lane = 2 * t4 * LD + g;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const int nt_n = min(NT, (s - k0 + 7) >> 3);  // n-tiles holding a real key
    const int kc_n = (nt_n + 1) >> 1;             // 16-key chunks holding a real key
    const float* const k_s = kv_s + 2 * (t & 1) * stage_rows * LD;
    const uint32_t k_addr = smem_u32(k_s + k_lane);
    const float* const v_s = k_s + stage_rows * LD + v_lane;

    cp_async_wait<3>();  // Q, K_t and its mask rows have landed (this thread's copies) ...
    __syncthreads();     // ... and everyone's
    if (t < 2) STAMP(t ? 8 : 3, clock64());

    // Mask bits of this warp's 16 rows: lane l reads key 32 w + l of each
    // staged row, one ballot per (row, w) makes the row's 32-key word, and
    // each thread keeps the words of its rows g and g + 8. Words wholly
    // past s are skipped: their keys get -inf whatever the mask says.
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
      for (int w = 0; w < NW; ++w) {
        if (k0 + 32 * w < s) {  // warp-uniform
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const uint32_t word = __ballot_sync(0xffffffffu, bytes[r][w] != 0u);
            if (r == g) bits_a[w] = word;
            if (r == g + 8) bits_b[w] = word;
          }
        }
      }
    }

    if (t == 0) STAMP(12, clock64());
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    if (active) {
      // S = Q K^T over this tile's real n-tiles, in 3xTF32.
      if (kc_n == KC)
        s_product<LD, KC, NT, true>(sc, q_addr, k_addr, d >> 3, kc_n, nt_n);
      else
        s_product<LD, KC, NT, false>(sc, q_addr, k_addr, d >> 3, kc_n, nt_n);
      if (t == 0) STAMP(13, clock64());

      // fp32 logits in base 2: scale, mask (-1e9), keys past s (-inf),
      // over every n-tile of the tile, without branches (n-tiles past s
      // hold zeros or products of zero-filled rows, and become -inf).
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
        for (int j = 0; j < DK; ++j) {
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
      // O += P V in 3xTF32, one 8-key k-step per n-tile of S, in a rolled
      // loop (as S's) that picks n-tile j of P out of registers by selects.
      // P's A fragment is the C fragment in key order (2 t4, 2 t4 + 1) ->
      // k-slots (t4, t4 + 4); V's B fragment is rows 2 t4 and 2 t4 + 1 at
      // column g of each d n-tile. A batch of V fragments is loaded before
      // its mma. Every d n-tile is run: past d, V's columns are zero-filled
      // and the epilogue does not write them, so no mma sits behind a
      // branch.
#pragma unroll 1
      for (int j = 0; j < nt_n; ++j) {
        float pj[4] = {sc[0][0], sc[0][2], sc[0][1], sc[0][3]};
#pragma unroll
        for (int jj = 1; jj < NT; ++jj) {
          if (j == jj) {
            pj[0] = sc[jj][0];
            pj[1] = sc[jj][2];
            pj[2] = sc[jj][1];
            pj[3] = sc[jj][3];
          }
        }
        uint32_t p_big[4], p_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(pj[i], p_big[i], p_small[i]);
        const float* const vj = v_s + 8 * j * LD;
#pragma unroll
        for (int d0 = 0; d0 < DK; d0 += VB) {
          {
            float v0[VB], v1[VB];
#pragma unroll
            for (int i = 0; i < VB; ++i) {
              v0[i] = vj[(d0 + i) * 8];
              v1[i] = vj[LD + (d0 + i) * 8];
            }
            uint32_t v_big[VB][2], v_small[VB][2];
#pragma unroll
            for (int i = 0; i < VB; ++i) {
              split_tf32(v0[i], v_big[i][0], v_small[i][0]);
              split_tf32(v1[i], v_big[i][1], v_small[i][1]);
            }
            // Three passes over the batch's d n-tiles, as in S.
#pragma unroll
            for (int i = 0; i < VB; ++i) mma_tf32(o[d0 + i], p_small, v_big[i][0], v_big[i][1]);
#pragma unroll
            for (int i = 0; i < VB; ++i) mma_tf32(o[d0 + i], p_big, v_small[i][0], v_small[i][1]);
#pragma unroll
            for (int i = 0; i < VB; ++i) mma_tf32(o[d0 + i], p_big, v_big[i][0], v_big[i][1]);
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
    // Normalise and write straight from the C fragments, 8 bytes a lane:
    // each store covers 32 contiguous bytes of 8 rows (out's rows start
    // 8-byte aligned: the wrapper allocates it contiguous, d % 8 == 0).
    const float inv_a = 1.f / quad_sum(l_a);
    const float inv_b = 1.f / quad_sum(l_b);
    const int ra = wq0 + g, rb = wq0 + g + 8;
    float* const out_a = ob + ra * os.s + 2 * t4;
    float* const out_b = ob + rb * os.s + 2 * t4;
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      if (j * 8 < d) {  // warp-uniform
        if (ra < s)
          *reinterpret_cast<float2*>(out_a + j * 8) = make_float2(o[j][0] * inv_a, o[j][1] * inv_a);
        if (rb < s)
          *reinterpret_cast<float2*>(out_b + j * 8) = make_float2(o[j][2] * inv_b, o[j][3] * inv_b);
      }
    }
  }
  STAMP(7, clock64());
}

template <int D, int BK>
size_t smem_bytes(int slices, int s, bool masked) {
  const int stage_rows = std::min(BK, (s + 15) & ~15);
  const int stages = s > BK ? 2 : 1;
  const size_t mask_ring = masked ? (size_t)stages * slices * 16 * (BK + 16) : 0;
  return sizeof(float) * (size_t)(slices * 16 + stages * 2 * stage_rows) * (D + PAD) + mask_ring;
}

// The most dynamic shared memory a block may opt in to (227 KB on an
// H100); 0 if the device cannot be asked, and then a large launch fails.
int smem_optin() {
  static const int bytes = [] {
    int dev = 0, value = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
    return value;
  }();
  return bytes;
}

template <int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int b, int s, int h, int d, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int slices, cudaStream_t stream TIMELINE_PARAM) {
  // Once per instance: the block may use up to the card's opt-in limit.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_tf32x3_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_optin());
  if (attr != cudaSuccess) return attr;
  const int chunks = (s + 15) / 16;
  const bool masked = mask != nullptr;
  slices = std::min(slices, chunks);
  // At d = 256 eight slices of Q do not fit beside K and V: take fewer.
  while (slices > 1 && smem_bytes<D, BK>(slices, s, masked) > (size_t)smem_optin()) --slices;
  dim3 grid(b * h, (chunks + slices - 1) / slices);
  const size_t smem = smem_bytes<D, BK>(slices, s, masked);
  attention_tf32x3_kernel<D, BK><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), h, s, d, qs, ks, vs, os,
      scale, slices TIMELINE_ARG);
  return cudaGetLastError();
}

}  // namespace

// float32 only. Strides are in elements; every row, and the mask's base,
// must start 16-byte aligned and d must be a multiple of 8 in [8, 256] (the
// wrapper's `_variant` checks these). `slices` (1..8) is the number of
// 16-row query slices per block (fewer where they would not fit in shared
// memory). A sequence that fits one key tile (s <= 128 at d <= 64, s <= 80
// at d <= 128, s <= 64 at d = 256) is taken in one, so at the serve shape
// (s = 66) K and V are read once, in one 80-key tile whose S fragments take
// 40 registers where a 128-key tile's take 64 (at d = 128 the kernel is
// near the 255-register limit, and a kernel at the limit reuses the mma
// operands' registers and serialises the mma); longer ones walk a
// two-stage ring of 64-key (d = 128) or 32-key (d = 256) tiles. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rt1_fused_attention_tf32x3_fwd(const void* q, const void* k, const void* v,
                                              const void* mask, void* out, int b, int s, int h,
                                              int d, long long q_sb, long long q_ss,
                                              long long q_sh, long long k_sb, long long k_ss,
                                              long long k_sh, long long v_sb, long long v_ss,
                                              long long v_sh, long long o_sb, long long o_ss,
                                              long long o_sh, float scale, int slices,
                                              void* stream TIMELINE_PARAM) {
  if (b < 1 || s < 1 || h < 1 || d < 8 || d > 256 || d % 8 != 0 || slices < 1 ||
      slices > WARPS)
    return (int)cudaErrorInvalidValue;
  Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s16 = (s + 15) & ~15;
  if (d <= 64)
    return (int)launch<64, 128>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale, slices,
                                st TIMELINE_ARG);
  if (d <= 128)
    return s16 <= 80 ? (int)launch<128, 80>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os,
                                            scale, slices, st TIMELINE_ARG)
                      : (int)launch<128, 64>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os,
                                             scale, slices, st TIMELINE_ARG);
  return s16 <= 64 ? (int)launch<256, 64>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale,
                                          slices, st TIMELINE_ARG)
                   : (int)launch<256, 32>(q, k, v, mask, out, b, s, h, d, qs, ks, vs, os, scale,
                                          slices, st TIMELINE_ARG);
}
