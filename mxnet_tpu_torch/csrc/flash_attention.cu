// Flash attention for Hopper (sm_90a): the forward on the tensor cores,
// and the backward as one pass over the query tiles.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py:
//   flash_attention_fwd_pallas (body _fwd_kernel)
//       out = softmax(q k^T * scale) v, lse = logsumexp(q k^T * scale)
//   flash_attention_bwd_pallas (bodies _bwd_dkv_kernel, _bwd_dq_kernel)
//       p = exp(s - lse); dv = p^T do; ds = p (do v^T - delta) * scale;
//       dk = ds^T q; dq = ds k
// over (bh, seq, d) tensors, with the optional causal mask and the
// optional (b, seq, seq) float mask (> 0 = attend; batch = bh / heads).
// A masked score is -1e30, as on the TPU, so a row whose keys are all
// masked averages them: out = mean of v, lse = -1e30 + log(seq), which
// fp32 holds as -1e30, and the backward gives each key of such a row
// softmax's weight 1 / seq (exp(s - lse) would give 1).  Causal alone
// leaves no row empty; only then do the kernels skip the tiles past the
// diagonal.  A key past the end of the sequence has weight 0.  delta =
// rowsum(dout * out) arrives from the caller, as on the TPU.
//
// Layout (all contiguous): q, k, v, out, dout, dq, dk, dv (bh, seq, d) of
// one dtype, fp32 or bf16; lse, delta (bh, seq) fp32; mask (b, seq, seq)
// fp32; dq_acc (bh, seq, d) fp32, zeroed by the caller (dq itself when
// the dtype is fp32).  Scores, softmax and every accumulation are fp32.
// Any seq (the edge tiles are bounds-checked) and head_dim <= 128
// (padded with zeros in shared memory to 32, 64 or 128).
//
// What bounds it: the forward does 4 * bh * seq^2 * d flops (two
// products) and the backward needs 10 * bh * seq^2 * d (five: S, dP,
// P^T dO, dS^T Q, dS K) against O(bh * seq * d) bytes, so both are bound
// by operations, far above the card's ridge.  Scores stay out of device
// memory.
//
// Forward: one block per (128 query rows, bh), eight warps of 16 rows.
// Both products run on the tensor cores through mma.sync.  bf16: m16n8k16
// bf16 products with fp32 sums, P rounded to bf16 before P V as the JAX
// package's XLA math rounds it.  fp32: 3xTF32 m16n8k8 products.  Each
// operand splits into big = tf32(x) and small = tf32(x - big), and
// small*big + big*small + big*big keeps about fp32's precision (one
// tf32 product keeps ~3 decimal digits) for three products at the
// 495 TFLOP/s TF32 rate, against 67 TFLOP/s of fp32 FMAs.  A warp's
// 16 x 64 scores stay in its accumulators; the online softmax's row max
// and sum are shuffles among the four lanes that hold a row, with no
// block barrier.  The accumulators become P V's A operand in registers:
// in bf16 two adjacent 8-key tiles pack into one 16-key operand; in fp32
// a lane's keys 2t and 2t + 1 stand as the operand's columns t and t + 4
// and V's rows are read in that order (the key is a summation index, so
// any order serves, and no value moves between lanes).  K and V tiles of
// 64 keys arrive double-buffered by 16-byte cp.async while the previous
// tile is computed (plain loads when d or a pointer does not allow it),
// with one barrier a tile.  Q, K and V keep their dtype in shared
// memory, rows padded by 16 bytes (4 fp32, 8 bf16) so that every
// fragment read falls in distinct banks; the products run over d
// rounded up to the k-step (8 tf32, 16 bf16).  In fp32, P V adds each
// 8-key step into O with a rounded fp32 add, since the tensor cores'
// accumulation rounds toward zero and over many keys biases O.  Eight warps share each
// K and V tile, so a tile is copied once for 128 rows, and at 128
// registers a thread (no spill at D <= 64) two blocks, 16 warps, share
// an SM; at the BERT shape (bh 384, seq 512) that is 1536 blocks.  A
// tile wholly inside seq with no mask and no key right of a warp's rows
// skips the per-score tests.
//
// Backward: one block per (64 keys, bh) keeps its K and V tiles in
// shared memory and makes one pass over the query tiles, doing only the
// five products: S and dP (4 x 4 a thread), P and dS to shared memory,
// dV += P^T dO and dK += dS^T Q in registers, dQ += dS K added into
// dq_acc by per-element atomics (bf16 inputs: a small kernel then casts
// dq_acc into dq).  Shared-memory rows are padded by four words, so
// every operand is read as float4s from distinct banks: eight FMAs a
// shared-memory load.  The next query tile's Q, dO, lse and delta are
// copied in with cp.async (fp32, aligned rows) while the block computes
// dQ.  At D <= 64 a block takes 103 KB of shared memory and 128
// registers a thread at most, so two blocks (16 warps) share an SM.
// The reductions into dq_acc arrive in no fixed order, so the order of
// dq's sums changes from run to run: two calls agree to fp32 rounding,
// not bit for bit; dk and dv are each written by one block and do not
// change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 64;          // query rows and keys of a tile
constexpr int kThreads = 256;      // the backward's block: 16 x 16
constexpr float kMasked = -1e30f;  // a masked score, as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// whether query row `qrow` may attend to key `key` (both inside seq)
__device__ __forceinline__ bool attends(const float* mask_b, int causal,
                                        int seq, int qrow, int key) {
  if (causal && key > qrow) return false;
  if (mask_b != nullptr &&
      !(mask_b[static_cast<int64_t>(qrow) * seq + key] > 0.f))
    return false;
  return true;
}

// cp.async of `bytes` (16 or 0: zero fill) to shared memory
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// tensor-core fragments (mma.sync; PTX ISA, "Matrix Fragments for
// mma.m16n8k8" and "... mma.m16n8k16").  In a warp, lane = 4 g + t.  A
// 16 x 8 fp32 accumulator c holds rows g (c[0], c[1]) and g + 8 (c[2],
// c[3]), columns 2t and 2t + 1.
// ---------------------------------------------------------------------

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// cvt.rna.tf32.f32 on a finite x: round half away from zero to tf32's
// 10 mantissa bits, as two integer operations (ptxas lowers the cvt to
// four, adding a test for inf and NaN; a NaN operand still gives NaN
// products through the small part, x - big)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both tf32 (the low 13 bits of the fp32 pattern zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small products first, then big * big
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4],
                                           const uint32_t as[4],
                                           const uint32_t bb[2],
                                           const uint32_t bs[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// fp32 A fragment of the 16 x 8 block at p (row stride ld): rows g and
// g + 8, columns t and t + 4
__device__ __forceinline__ void frag_a(const float* p, int ld,
                                       uint32_t big[4], uint32_t small[4]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  p += g * ld + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * ld], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * ld + 4], big[3], small[3]);
}

// fp32 B fragment (k 8 x n 8) of B[k][n] = p[n * ld + k], the rows of K:
// k = t and t + 4, n = g
__device__ __forceinline__ void frag_b_rows(const float* p, int ld,
                                            uint32_t big[2],
                                            uint32_t small[2]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  p += g * ld + t;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// fp32 B fragment of B[k][n] = p[key(k) * ld + n], the rows of V, in the
// key order of frag_a_from_c: k = t is key 2t, k = t + 4 key 2t + 1
__device__ __forceinline__ void frag_b_cols(const float* p, int ld,
                                            uint32_t big[2],
                                            uint32_t small[2]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  p += 2 * t * ld + g;
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[ld], big[1], small[1]);
}

// fp32 A fragment of P from its accumulator (keys 2t, 2t + 1 of rows g
// and g + 8): columns t and t + 4 stand for keys 2t and 2t + 1
__device__ __forceinline__ void frag_a_from_c(const float c[4],
                                              uint32_t big[4],
                                              uint32_t small[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// bf16 A fragment of the 16 x 16 block at p: rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9
__device__ __forceinline__ void frag_a(const __nv_bfloat16* p, int ld,
                                       uint32_t a[4]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  p += g * ld + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// bf16 B fragment (k 16 x n 8) of B[k][n] = p[n * ld + k]: k = 2t, 2t + 1
// and 2t + 8, 2t + 9, n = g
__device__ __forceinline__ void frag_b_rows(const __nv_bfloat16* p, int ld,
                                            uint32_t b[2]) {
  const int g = lane_id() >> 2, t = lane_id() & 3;
  p += g * ld + 2 * t;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// bf16 B fragment of B[k][n] = p[k * ld + n], the rows of V: two 8 x 8
// matrices (keys 0-7 and 8-15) transposed by ldmatrix, whose row
// addresses come from lanes 0-15 (rows 16-byte aligned)
__device__ __forceinline__ void frag_b_cols(const __nv_bfloat16* p, int ld,
                                            uint32_t b[2]) {
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(p + (lane_id() & 15) * ld));
  asm volatile("ldmatrix.sync.aligned.x2.trans.m8n8.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s)
               : "memory");
}

// bf16 A fragment of P (16 keys) from the accumulators of its two 8-key
// halves, rounded to bf16
__device__ __forceinline__ void frag_a_from_c(const float lo[4],
                                              const float hi[4],
                                              uint32_t a[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ---------------------------------------------------------------------
// forward: one block per (128 query rows, bh), eight warps of 16 rows
// ---------------------------------------------------------------------

constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kFwdWarps;  // query rows of a block
constexpr float kLog2e = 1.4426950408889634f;

// Q [128][kLd], K and V [64][kLd] tiles in the input dtype.  Padding a
// row by 16 bytes makes the row stride 4 words mod 32 (fp32, and bf16 at
// D 64 and 128; 20 at D 32): the fragment reads at (row g, word t) and
// the fp32 V reads at (rows 2t and 2t + 1, column g) fall in distinct
// banks, as do ldmatrix's eight 16-byte rows; rows stay 16-byte aligned
// for cp.async and ldmatrix
template <typename T, int D>
struct Fwd {
  static constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte copy
  static constexpr int kLd = D + kVec;
  static constexpr int kStep = sizeof(T) == 4 ? 8 : 16;  // the MMA's k
  // two blocks (16 warps) an SM up to D 64, so at most 128 registers a
  // thread; at D 128 shared memory leaves room for one
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  // Q, then K and V twice each
  static constexpr size_t kSmem = sizeof(T) * (kFwdRows + 4 * kTile) * kLd;
};

// rows row0 .. row0+kRows-1 of a (seq, d) matrix into a [kRows][kLd]
// tile, zero outside the matrix: 16-byte cp.async chunks (kAsync: d a
// multiple of kVec, 16-byte aligned), else plain loads.  A thread keeps
// one column of chunks and takes every kStride-th row
template <typename T, int D, int kRows, bool kAsync>
__device__ __forceinline__ void fwd_load_tile(T* dst, const T* src,
                                              int row0, int seq, int d) {
  constexpr int kLd = Fwd<T, D>::kLd;
  constexpr int kVec = Fwd<T, D>::kVec;
  constexpr int kChunks = D / kVec;
  constexpr int kStride = kFwdThreads / kChunks;
  static_assert(kFwdThreads % kChunks == 0 && kRows % kStride == 0, "");
  const int c = (threadIdx.x % kChunks) * kVec;
  const int r0 = threadIdx.x / kChunks;
  const T* from = src + static_cast<int64_t>(row0 + r0) * d + c;
  T* to = dst + r0 * kLd + c;
  // plain loads one chunk at a time: unrolled, they hold many registers
#pragma unroll (kAsync ? kRows / kStride : 1)
  for (int i = 0; i < kRows / kStride; ++i) {
    const int row = row0 + r0 + i * kStride;
    if constexpr (kAsync) {
      const bool live = row < seq && c < d;
      cp_async16(to, live ? from : src, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        to[e] = row < seq && c + e < d ? from[e] : from_f32<T>(0.f);
    }
    from += static_cast<int64_t>(kStride) * d;
    to += kStride * kLd;
  }
}

// s[n] = the warp's 16 rows of Q (at Qw) times keys 8n .. 8n+7 of the
// tile, over the first dk columns
template <int D>
__device__ __forceinline__ void qk_product(const float* Qw, const float* Ks,
                                           int dk, float s[8][4]) {
  constexpr int kLd = Fwd<float, D>::kLd;
#pragma unroll 2
  for (int k0 = 0; k0 < dk; k0 += 8) {
    uint32_t ab[4], as[4];
    frag_a(Qw + k0, kLd, ab, as);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bb[2], bs[2];
      frag_b_rows(Ks + n * 8 * kLd + k0, kLd, bb, bs);
      mma_3xtf32(s[n], ab, as, bb, bs);
    }
  }
}

template <int D>
__device__ __forceinline__ void qk_product(const __nv_bfloat16* Qw,
                                           const __nv_bfloat16* Ks, int dk,
                                           float s[8][4]) {
  constexpr int kLd = Fwd<__nv_bfloat16, D>::kLd;
#pragma unroll 2
  for (int k0 = 0; k0 < dk; k0 += 16) {
    uint32_t a[4];
    frag_a(Qw + k0, kLd, a);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t b[2];
      frag_b_rows(Ks + n * 8 * kLd + k0, kLd, b);
      mma_bf16(s[n], a, b);
    }
  }
}

// o[n] += P V: P the warp's 16 x 64 probabilities in s, o[n] output
// columns 8n .. 8n+7 (those at or past d are left out).  In fp32 each
// 8-key step's three products are summed from zero and added into o by
// a rounded fp32 add: the tensor cores' own accumulation rounds toward
// zero, and over the 64 steps of 512 keys that would pull out toward
// zero by several times fp32's error
template <int D>
__device__ __forceinline__ void pv_product(const float s[8][4],
                                           const float* Vs, int d,
                                           float o[D / 8][4]) {
  constexpr int kLd = Fwd<float, D>::kLd;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    frag_a_from_c(s[kk], ab, as);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (n * 8 >= d) break;
      uint32_t bb[2], bs[2];
      frag_b_cols(Vs + kk * 8 * kLd + n * 8, kLd, bb, bs);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(c, ab, as, bb, bs);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += c[e];
    }
  }
}

template <int D>
__device__ __forceinline__ void pv_product(const float s[8][4],
                                           const __nv_bfloat16* Vs, int d,
                                           float o[D / 8][4]) {
  constexpr int kLd = Fwd<__nv_bfloat16, D>::kLd;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    frag_a_from_c(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (n * 8 >= d) break;
      uint32_t b[2];
      frag_b_cols(Vs + kk * 16 * kLd + n * 8, kLd, b);
      mma_bf16(o[n], a, b);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the SFU (ex2.approx.ftz, within 2 ulp; a weight below 2^-126
// of the row's largest, 1, flushes to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Per key tile: wait for its cp.async copies, one barrier (the tile is
// in, and every warp is done with the buffer the next copy takes), issue
// the next tile's copies, then in each warp S = Q K^T into accumulators,
// the online softmax of rows g and g + 8 (lanes 4g .. 4g+3), and O += P V
template <typename T, int D, bool kAsync>
__global__ void __launch_bounds__(kFwdThreads, Fwd<T, D>::kMinBlocks)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int seq,
                     int d, int heads, float scale, int causal) {
  using F = Fwd<T, D>;
  constexpr int kLd = F::kLd;
  constexpr int kSize = kTile * kLd;
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_f[];
  T* Qs = reinterpret_cast<T*>(smem_f);
  T* Ks = Qs + kFwdRows * kLd;  // two buffers
  T* Vs = Ks + 2 * kSize;       // two buffers

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x >> 5;
  const int g = lane_id() >> 2, t = lane_id() & 3;
  const int64_t base = static_cast<int64_t>(bh) * seq * d;
  const float* mask_b =
      mask ? mask + static_cast<int64_t>(bh / heads) * seq * seq : nullptr;
  const int dk = (d + F::kStep - 1) / F::kStep * F::kStep;

  // causal alone: keys right of a row have weight 0, so a block stops
  // at the tile of its last row, and a warp passes over tiles wholly
  // right of its rows.  With a mask too, a row may have no key and then
  // averages every key, so every tile is visited
  const bool skip_right = causal && mask == nullptr;
  int num_kv = (seq + kTile - 1) / kTile;
  if (skip_right) num_kv = min(num_kv, (q0 + kFwdRows - 1) / kTile + 1);

  fwd_load_tile<T, D, kFwdRows, kAsync>(Qs, q + base, q0, seq, d);
  fwd_load_tile<T, D, kTile, kAsync>(Ks, k + base, 0, seq, d);
  fwd_load_tile<T, D, kTile, kAsync>(Vs, v + base, 0, seq, d);
  if constexpr (kAsync) cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const T* Qw = Qs + warp * 16 * kLd;

  for (int j = 0; j < num_kv; ++j) {
    if constexpr (kAsync) cp_async_wait_all();
    __syncthreads();
    if (j + 1 < num_kv) {
      const int nb = (j + 1) & 1;
      fwd_load_tile<T, D, kTile, kAsync>(Ks + nb * kSize, k + base,
                                         (j + 1) * kTile, seq, d);
      fwd_load_tile<T, D, kTile, kAsync>(Vs + nb * kSize, v + base,
                                         (j + 1) * kTile, seq, d);
      if constexpr (kAsync) cp_async_commit();
    }
    const int k0 = j * kTile;
    // a warp past the end of seq, or (causal) left of the whole tile,
    // has nothing to add
    if (q0 + warp * 16 >= seq || (skip_right && k0 > q0 + warp * 16 + 15))
      continue;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    qk_product<D>(Qw, Ks + (j & 1) * kSize, dk, s);

    // a tile wholly inside seq, with no mask and (causal) no key right
    // of the warp's first row, needs no test of a score
    if (mask_b == nullptr && k0 + kTile <= seq &&
        !(causal && k0 + kTile - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = rows[e >> 1];
          float val = -INFINITY;  // past the end: no weight
          if (key < seq) {
            val = s[n][e] * scale;
            if (row < seq && !attends(mask_b, causal, seq, row, key))
              val = kMasked;
          }
          s[n][e] = val;
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        tmax = fmaxf(tmax, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(tmax));
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_sfu((s[n][2 * i + e] - m_new) * kLog2e);
          s[n][2 * i + e] = p;
          rsum += p;
        }
      const float alpha = exp2_sfu((m[i] - m_new) * kLog2e);
      l[i] = alpha * l[i] + quad_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    pv_product<D>(s, Vs + (j & 1) * kSize, d, o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= seq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l_safe;
    T* orow = out + base + static_cast<int64_t>(rows[i]) * d;
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        if (col < d) orow[col] = from_f32<T>(o[n][2 * i + e] * inv);
      }
    if (t == 0)
      lse[static_cast<int64_t>(bh) * seq + rows[i]] = m[i] + logf(l_safe);
  }
}

// One warp: c[0:128] = a b^T through the score product's fragments (a
// 16 x K, b 8 x K) and c[128:256] = p v through the output product's (p
// 16 x K fp32 placed in score accumulators, v K x 8), each 16 x 8
// row-major; K = 8 (fp32, 3xTF32) or 16 (bf16)
template <typename T>
__global__ void mma_test_kernel(const T* a, const T* b, const float* p,
                                const T* v, float* c) {
  constexpr int kK = Fwd<T, 32>::kStep;
  constexpr int kLd = kK + Fwd<T, 32>::kVec;
  __shared__ __align__(16) T As[16 * kLd];
  __shared__ __align__(16) T Bs[8 * kLd];
  __shared__ __align__(16) T Vs[kK * kLd];
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  for (int i = lane; i < 16 * kK; i += 32) As[i / kK * kLd + i % kK] = a[i];
  for (int i = lane; i < 8 * kK; i += 32) Bs[i / kK * kLd + i % kK] = b[i];
  for (int i = lane; i < kK * 8; i += 32) Vs[i / 8 * kLd + i % 8] = v[i];
  __syncwarp();
  float pc[2][4];
#pragma unroll
  for (int h = 0; h < kK / 8; ++h) {
    const int col = 8 * h + 2 * t;
    pc[h][0] = p[g * kK + col];
    pc[h][1] = p[g * kK + col + 1];
    pc[h][2] = p[(g + 8) * kK + col];
    pc[h][3] = p[(g + 8) * kK + col + 1];
  }
  float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (sizeof(T) == 4) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    frag_a(As, kLd, ab, as);
    frag_b_rows(Bs, kLd, bb, bs);
    mma_3xtf32(c1, ab, as, bb, bs);
    frag_a_from_c(pc[0], ab, as);
    frag_b_cols(Vs, kLd, bb, bs);
    mma_3xtf32(c2, ab, as, bb, bs);
  } else {
    uint32_t a4[4], b2[2];
    frag_a(As, kLd, a4);
    frag_b_rows(Bs, kLd, b2);
    mma_bf16(c1, a4, b2);
    frag_a_from_c(pc[0], pc[1], a4);
    frag_b_cols(Vs, kLd, b2);
    mma_bf16(c2, a4, b2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      c[(g + 8 * i) * 8 + 2 * t + e] = c1[2 * i + e];
      c[128 + (g + 8 * i) * 8 + 2 * t + e] = c2[2 * i + e];
    }
}

// ---------------------------------------------------------------------
// backward: one block per (64 keys, bh), one pass over the query tiles
// ---------------------------------------------------------------------

constexpr int kLdPB = kTile + 4;  // row stride of the P and dS tiles

// the backward's (64, D) tiles: rows padded by 4 words, so that a row
// starts 16-byte aligned and the 8 rows a quarter-warp reads as float4s
// fall in distinct banks.  A thread owns D/16 output columns, kNv
// vectors of kVw: columns j*16*kVw + tx*kVw + c
template <int D>
struct Bwd {
  static constexpr int kLd = D + 4;
  static constexpr int kCols = D / 16;
  static constexpr int kVw = kCols < 4 ? kCols : 4;
  static constexpr int kNv = kCols / kVw;
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static constexpr size_t kSmem =
      sizeof(float) * (4 * kTile * kLd + 2 * kTile * kLdPB + 2 * kTile);
};

template <int W>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// rows row0 .. row0+63 of a (seq, d) matrix into a [64][D+4] fp32 tile,
// zero outside the matrix: 16-byte cp.async chunks (kAsync: fp32, d % 4
// == 0, 16-byte aligned), else plain loads converted to fp32
template <typename T, int D, bool kAsync>
__device__ __forceinline__ void bwd_load_tile(float* dst, const T* src,
                                              int row0, int seq, int d) {
  constexpr int kLd = Bwd<D>::kLd;
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const int row = row0 + r;
    float* to = dst + r * kLd + c;
    if constexpr (kAsync) {
      const bool live = row < seq && c < d;
      cp_async16(to, live ? src + static_cast<int64_t>(row) * d + c : src,
                 live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        to[e] = row < seq && c + e < d
                    ? to_f32(src[static_cast<int64_t>(row) * d + c + e])
                    : 0.f;
    }
  }
}

// elements row0 .. row0+63 of a (seq,) fp32 vector, zero outside
template <bool kAsync>
__device__ __forceinline__ void bwd_load_vec(float* dst, const float* src,
                                             int row0, int seq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool live = row0 + r < seq;
    if constexpr (kAsync)
      cp_async4(dst + r, live ? src + row0 + r : src, live ? 4 : 0);
    else
      dst[r] = live ? src[row0 + r] : 0.f;
  }
}

// Per query tile: S = Q K^T and dP = dO V^T (rows ty*4+r, keys tx+16c,
// 4 x 4 a thread, float4 reads along d); P = exp(S * scale - lse) and
// dS = P (dP - delta) * scale to shared memory; dV += P^T dO and dK +=
// dS^T Q in registers (keys ty*4+r, D/16 columns a thread); then the
// next tile's loads are issued, and dQ += dS K (rows ty*4+r) is added
// into fp32 dq_acc by per-element atomics.
template <typename T, int D, bool kAsync>
__global__ void __launch_bounds__(kThreads, Bwd<D>::kMinBlocks)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int seq, int d, int heads,
                     float scale, int causal) {
  using B = Bwd<D>;
  constexpr int kLd = B::kLd;
  constexpr int kCols = B::kCols;
  constexpr int kVw = B::kVw;
  constexpr int kNv = B::kNv;
  extern __shared__ __align__(16) float smem_b[];
  float* Ks = smem_b;
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* dOs = Qs + kTile * kLd;
  float* Ps = dOs + kTile * kLd;    // [64 q][68]: p
  float* dSs = Ps + kTile * kLdPB;  // [64 q][68]: ds
  float* lse_s = dSs + kTile * kLdPB;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t base = static_cast<int64_t>(bh) * seq * d;
  const int64_t vbase = static_cast<int64_t>(bh) * seq;
  const float* mask_b =
      mask ? mask + static_cast<int64_t>(bh / heads) * seq * seq : nullptr;

  const int num_q = (seq + kTile - 1) / kTile;
  // causal alone: query tiles wholly above the first key never attend
  // to it.  With a mask too, a row may have no key, and then every key
  // carries its weight, so every query tile takes part
  const int start =
      causal && mask == nullptr ? static_cast<int>(blockIdx.x) : 0;
  bwd_load_tile<T, D, kAsync>(Ks, k + base, k0, seq, d);
  bwd_load_tile<T, D, kAsync>(Vs, v + base, k0, seq, d);
  bwd_load_tile<T, D, kAsync>(Qs, q + base, start * kTile, seq, d);
  bwd_load_tile<T, D, kAsync>(dOs, dout + base, start * kTile, seq, d);
  bwd_load_vec<kAsync>(lse_s, lse + vbase, start * kTile, seq);
  bwd_load_vec<kAsync>(delta_s, delta + vbase, start * kTile, seq);
  if constexpr (kAsync) {
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int i = start; i < num_q; ++i) {
    const int q0 = i * kTile;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int e = 0; e < D; e += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lds<4>(Qs + (ty * 4 + r) * kLd + e, a[r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) lds<4>(Ks + (tx + 16 * c) * kLd + e, b[c]);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r][x], b[c][x], s[r][c]);
#pragma unroll
      for (int r = 0; r < 4; ++r) lds<4>(dOs + (ty * 4 + r) * kLd + e, a[r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) lds<4>(Vs + (tx + 16 * c) * kLd + e, b[c]);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dp[r][c] = fmaf(a[r][x], b[c][x], dp[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qrow = q0 + ty * 4 + r;
      const float lse_r = lse_s[ty * 4 + r];
      const float delta_r = delta_s[ty * 4 + r];
      // a row with no key: every score is kMasked, and fp32 holds its
      // lse, kMasked + log(seq), as kMasked, so exp(s - lse) is 1 where
      // softmax gives each key 1 / seq
      const float w_r = lse_r <= kMasked ? 1.f / seq : 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float p = 0.f, ds = 0.f;
        if (qrow < seq && key < seq) {
          float val = s[r][c] * scale;
          if (!attends(mask_b, causal, seq, qrow, key)) val = kMasked;
          p = expf(val - lse_r) * w_r;
          ds = p * (dp[r][c] - delta_r) * scale;
        }
        Ps[(ty * 4 + r) * kLdPB + tx + 16 * c] = p;
        dSs[(ty * 4 + r) * kLdPB + tx + 16 * c] = ds;
      }
    }
    __syncthreads();

    // dv[key][:] += sum_q p[q][key] do[q][:]; dk[key][:] += ds[q][key] q[q][:]
#pragma unroll 2
    for (int qq = 0; qq < kTile; ++qq) {
      float p4[4], ds4[4];
      lds<4>(Ps + qq * kLdPB + ty * 4, p4);
      lds<4>(dSs + qq * kLdPB + ty * 4, ds4);
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        float o[kVw], x[kVw];
        lds<kVw>(dOs + qq * kLd + j * 16 * kVw + tx * kVw, o);
        lds<kVw>(Qs + qq * kLd + j * 16 * kVw + tx * kVw, x);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kVw; ++c) {
            dv_acc[r][j * kVw + c] = fmaf(p4[r], o[c], dv_acc[r][j * kVw + c]);
            dk_acc[r][j * kVw + c] = fmaf(ds4[r], x[c], dk_acc[r][j * kVw + c]);
          }
      }
    }
    __syncthreads();  // Qs, dOs, lse_s and delta_s are free

    if (i + 1 < num_q) {
      const int n0 = q0 + kTile;
      bwd_load_tile<T, D, kAsync>(Qs, q + base, n0, seq, d);
      bwd_load_tile<T, D, kAsync>(dOs, dout + base, n0, seq, d);
      bwd_load_vec<kAsync>(lse_s, lse + vbase, n0, seq);
      bwd_load_vec<kAsync>(delta_s, delta + vbase, n0, seq);
      if constexpr (kAsync) cp_async_commit();
    }

    // dq[q][:] += sum_key ds[q][key] k[key][:]
    float acc[4][kCols];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lds<4>(dSs + (ty * 4 + r) * kLdPB + kk, a[r]);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int j = 0; j < kNv; ++j) {
          float b[kVw];
          lds<kVw>(Ks + (kk + x) * kLd + j * 16 * kVw + tx * kVw, b);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < kVw; ++c)
              acc[r][j * kVw + c] = fmaf(a[r][x], b[c], acc[r][j * kVw + c]);
        }
    }
    const int rows = min(kTile, seq - q0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (ty * 4 + r >= rows) continue;
      float* row = dq_acc + base + static_cast<int64_t>(q0 + ty * 4 + r) * d;
#pragma unroll
      for (int j = 0; j < kNv; ++j)
#pragma unroll
        for (int c = 0; c < kVw; ++c) {
          const int col = j * 16 * kVw + tx * kVw + c;
          if (col < d) atomicAdd(row + col, acc[r][j * kVw + c]);
        }
    }

    if constexpr (kAsync) cp_async_wait_all();
    __syncthreads();  // the next tile has landed; Ps and dSs may be rewritten
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= seq) continue;
    const int64_t off = base + static_cast<int64_t>(key) * d;
#pragma unroll
    for (int j = 0; j < kNv; ++j)
#pragma unroll
      for (int c = 0; c < kVw; ++c) {
        const int col = j * 16 * kVw + tx * kVw + c;
        if (col < d) {
          dk[off + col] = from_f32<T>(dk_acc[r][j * kVw + c]);
          dv[off + col] = from_f32<T>(dv_acc[r][j * kVw + c]);
        }
      }
  }
}

// dq = dq_acc in the input dtype (bf16 inputs)
template <typename T>
__global__ void cast_dq_kernel(const float* __restrict__ src,
                               T* __restrict__ dst, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dst[i] = from_f32<T>(src[i]);
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* mask;
  void* out;       // forward: out; backward: dq
  float* lse;      // forward only
  float* dq_acc;   // backward only: fp32, zeroed; dq itself for fp32
  void* dk;
  void* dv;
  int bh, seq, d, heads, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool kAsync>
cudaError_t launch_fwd_kernel(const Args& a) {
  const size_t smem = Fwd<T, D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kFwdRows - 1) / kFwdRows, a.bh);
  flash_fwd_kernel<T, D, kAsync><<<grid, kFwdThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.lse,
      a.seq, a.d, a.heads, a.scale, a.causal);
  return cudaGetLastError();
}

// 16-byte copies when d fills whole chunks and q, k, v are 16-byte
// aligned (the rows then are too)
template <typename T, int D>
bool fwd_async(const Args& a) {
  return a.d % Fwd<T, D>::kVec == 0 &&
         (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v)) % 16 == 0;
}

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  return fwd_async<T, D>(a) ? launch_fwd_kernel<T, D, true>(a)
                            : launch_fwd_kernel<T, D, false>(a);
}

template <typename T, int D, bool kAsync>
cudaError_t launch_bwd_kernel(const Args& a) {
  const size_t smem = Bwd<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D, kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kTile - 1) / kTile, a.bh);
  flash_bwd_kernel<T, D, kAsync><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, a.mask, a.dq_acc, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.seq, a.d, a.heads, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const Args& a) {
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const bool aligned =
        a.d % 4 == 0 && (reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) |
                         reinterpret_cast<uintptr_t>(a.dout)) % 16 == 0;
    err = aligned ? launch_bwd_kernel<T, D, true>(a)
                  : launch_bwd_kernel<T, D, false>(a);
  } else {
    err = launch_bwd_kernel<T, D, false>(a);
  }
  if (err != cudaSuccess || static_cast<void*>(a.dq_acc) == a.out) return err;
  const int64_t n = static_cast<int64_t>(a.bh) * a.seq * a.d;
  const int blocks = static_cast<int>(std::min<int64_t>((n + 255) / 256, 4096));
  cast_dq_kernel<T><<<blocks, 256, 0, a.stream>>>(a.dq_acc,
                                                  static_cast<T*>(a.out), n);
  return cudaGetLastError();
}

// registers, local (spill) bytes a thread, and static and dynamic shared
// memory a block of the forward kernel that launch_fwd would take
template <typename T, int D>
cudaError_t fwd_attributes(const Args& a, int* out) {
  cudaFuncAttributes at;
  const cudaError_t err =
      fwd_async<T, D>(a)
          ? cudaFuncGetAttributes(&at, flash_fwd_kernel<T, D, true>)
          : cudaFuncGetAttributes(&at, flash_fwd_kernel<T, D, false>);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  out[3] = static_cast<int>(Fwd<T, D>::kSmem);
  return cudaSuccess;
}

enum What { kForward, kBackward, kForwardAttributes };

template <typename T, int D>
cudaError_t act(const Args& a, What what, int* attrs) {
  switch (what) {
    case kForward:
      return launch_fwd<T, D>(a);
    case kBackward:
      return launch_bwd<T, D>(a);
    default:
      return fwd_attributes<T, D>(a, attrs);
  }
}

// the padded head dim: 32, 64 or 128
template <typename T>
cudaError_t dispatch(const Args& a, What what, int* attrs) {
  if (a.d <= 32) return act<T, 32>(a, what, attrs);
  if (a.d <= 64) return act<T, 64>(a, what, attrs);
  if (a.d <= 128) return act<T, 128>(a, what, attrs);
  return cudaErrorInvalidValue;
}

cudaError_t run(const Args& a, int dtype, What what,
                int* attrs = nullptr) {
  switch (dtype) {
    case 0:
      return dispatch<float>(a, what, attrs);
    case 1:
      return dispatch<__nv_bfloat16>(a, what, attrs);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `mask` may be null; `causal`
// is 0 or 1; the backward's `dq_acc` is zeroed fp32 (`dq` itself for
// fp32), which the bf16 backward casts into `dq`.  Each returns the
// cudaError_t of its launches (0 = cudaSuccess).  Asynchronous on
// `stream`; allocates nothing.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const float* mask, void* out, float* lse,
                                int bh, int seq, int d, int heads,
                                float scale, int causal, int dtype,
                                void* stream) {
  if (bh == 0 || seq == 0 || d == 0) return 0;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = mask;
  a.out = out;
  a.lse = lse;
  a.bh = bh;
  a.seq = seq;
  a.d = d;
  a.heads = heads;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(run(a, dtype, kForward));
}

extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const float* mask,
                                float* dq_acc, void* dq, void* dk, void* dv,
                                int bh,
                                int seq, int d, int heads, float scale,
                                int causal, int dtype, void* stream) {
  if (bh == 0 || seq == 0 || d == 0) return 0;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.mask = mask;
  a.out = dq;
  a.dq_acc = dq_acc;
  a.dk = dk;
  a.dv = dv;
  a.bh = bh;
  a.seq = seq;
  a.d = d;
  a.heads = heads;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(run(a, dtype, kBackward));
}

// what the forward kernel that flash_fwd_launch would take for these
// q, k, v pointers and d uses: out = {registers a thread, local (spill)
// bytes a thread, static shared bytes, dynamic shared bytes a block}
extern "C" int flash_fwd_attributes(const void* q, const void* k,
                                    const void* v, int d, int dtype,
                                    int* out) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.d = d;
  return static_cast<int>(run(a, dtype, kForwardAttributes, out));
}

// One warp through the forward's MMA fragment helpers (mma_test_kernel):
// a (16, K), b (8, K), v (K, 8) of the dtype, p (16, K) fp32, c (2, 16,
// 8) fp32; K = 8 for fp32, 16 for bf16
extern "C" int flash_mma_test_launch(const void* a, const void* b,
                                     const float* p, const void* v,
                                     float* c, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    mma_test_kernel<float><<<1, 32, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), p,
        static_cast<const float*>(v), c);
  else if (dtype == 1)
    mma_test_kernel<__nv_bfloat16><<<1, 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), p,
        static_cast<const __nv_bfloat16*>(v), c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
