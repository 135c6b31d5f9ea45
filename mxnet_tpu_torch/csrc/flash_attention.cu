// Flash attention for Hopper (sm_90a): forward, and the backward as one
// pass over the query tiles.
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
// masked averages them; a key past the end of the sequence has weight 0.
// delta = rowsum(dout * out) arrives from the caller, as on the TPU.
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
// P^T dO, dS^T Q, dS K) against O(bh * seq * d) bytes, so in fp32 on the
// CUDA cores it is bound by operations (67 TFLOP/s), far above the
// card's ridge.  Scores stay out of device memory.
//
// Forward (simple first): one block per (64 query rows, bh), 256 threads
// as 16 x 16, each computing a 4 x 4 micro-tile of the 64 x 64 score
// tile (rows ty*4.., keys tx+16c) with fp32 FMAs from shared memory, and
// a 4 x (D/16) tile of the 64 x D output.  Row reductions of the online
// softmax are shuffles within a half-warp (the 16 threads of a row
// group).  Shared-memory rows are padded by one word so that column
// reads fall in distinct banks.
//
// Backward: one block per (64 keys, bh) keeps its K and V tiles in
// shared memory and makes one pass over the query tiles, doing only the
// five products: S and dP (4 x 4 a thread), P and dS to shared memory,
// dV += P^T dO and dK += dS^T Q in registers, dQ += dS K added into
// dq_acc by per-element atomics (bf16 inputs: a small kernel then casts
// dq_acc into dq).  Shared-memory rows are padded by four words, so
// every operand is read as float4s from distinct banks: eight FMAs a
// shared-memory load, where the forward's scalar reads give two.  The
// next query tile's Q, dO, lse and delta are copied in with cp.async
// (fp32, aligned rows) while the block computes dQ.  At D <= 64 a block
// takes 103 KB of shared memory and 128 registers a thread at most, so
// two blocks (16 warps) share an SM.
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
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdP = kTile + 1;    // row stride of a score tile in smem
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

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0+63 of a (seq, d) matrix into a [64][D+1] fp32 tile,
// zero outside the matrix
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int seq, int d) {
  constexpr int kLd = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < seq && c < d) val = to_f32(src[static_cast<int64_t>(row) * d + c]);
    dst[r * kLd + c] = val;
  }
}

// out[r][c] = sum_e A[ty*4+r][e] * B[tx+16c][e], A and B [64][D+1] tiles
template <int D>
__device__ __forceinline__ void tile_abt(const float* A, const float* B,
                                         int ty, int tx, float out[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty * 4 + r) * kLd + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * kLd + e];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[r][c] = fmaf(a[r], b[c], out[r][c]);
  }
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

// ---------------------------------------------------------------------
// forward: one block per (64 query rows, bh)
// ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, int seq, int d,
    int heads, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ps = Vs + kTile * kLd;  // [64][65]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t base = static_cast<int64_t>(bh) * seq * d;
  const float* mask_b =
      mask ? mask + static_cast<int64_t>(bh / heads) * seq * seq : nullptr;

  load_tile<T, D>(Qs, q + base, q0, seq, d);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  int num_kv = (seq + kTile - 1) / kTile;
  // causal: only key tiles at or left of the diagonal contribute
  if (causal) num_kv = min(num_kv, static_cast<int>(blockIdx.x) + 1);

  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + base, k0, seq, d);
    load_tile<T, D>(Vs, v + base, k0, seq, d);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qrow = q0 + ty * 4 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float val = -INFINITY;  // past the end: no weight
        if (key < seq) {
          val = s[r][c] * scale;
          if (qrow < seq && !attends(mask_b, causal, seq, qrow, key))
            val = kMasked;
        }
        s[r][c] = val;
        tmax = fmaxf(tmax, val);
      }
      const float m_new = fmaxf(m[r], half_warp_max(tmax));
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        s[r][c] = p;
        rsum += p;
      }
      rsum = half_warp_sum(rsum);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(ty * 4 + r) * kLdP + tx + 16 * c] = s[r][c];
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int e = 0; e < kTile; ++e) {
      float a[4], b[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ps[(ty * 4 + r) * kLdP + e];
#pragma unroll
      for (int c = 0; c < C; ++c) b[c] = Vs[e * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qrow = q0 + ty * 4 + r;
    if (qrow >= seq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* orow = out + base + static_cast<int64_t>(qrow) * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) orow[col] = from_f32<T>(acc[r][c] / l_safe);
    }
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * seq + qrow] = m[r] + logf(l_safe);
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

// cp.async of `bytes` (16 or 0: zero fill) to shared memory
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
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
  // causal: query tiles wholly above the first key never attend to it
  const int start = causal ? static_cast<int>(blockIdx.x) : 0;
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
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float p = 0.f, ds = 0.f;
        if (qrow < seq && key < seq) {
          float val = s[r][c] * scale;
          if (!attends(mask_b, causal, seq, qrow, key)) val = kMasked;
          p = expf(val - lse_r);
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

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdP);
}

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

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kTile - 1) / kTile, a.bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<T*>(a.out), a.lse,
      a.seq, a.d, a.heads, a.scale, a.causal);
  return cudaGetLastError();
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

// the padded head dim: 32, 64 or 128
template <typename T>
cudaError_t dispatch(const Args& a, bool backward) {
  if (a.d <= 32)
    return backward ? launch_bwd<T, 32>(a) : launch_fwd<T, 32>(a);
  if (a.d <= 64)
    return backward ? launch_bwd<T, 64>(a) : launch_fwd<T, 64>(a);
  if (a.d <= 128)
    return backward ? launch_bwd<T, 128>(a) : launch_fwd<T, 128>(a);
  return cudaErrorInvalidValue;
}

cudaError_t run(const Args& a, int dtype, bool backward) {
  switch (dtype) {
    case 0:
      return dispatch<float>(a, backward);
    case 1:
      return dispatch<__nv_bfloat16>(a, backward);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `mask` may be null; `causal`
// is 0 or 1; the backward's `dq_acc` is zeroed fp32 (`dq` itself for
// fp32), which the bf16 backward casts into `dq`.  Each returns the cudaError_t of its launches (0 =
// cudaSuccess).  Asynchronous on `stream`; allocates nothing.
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
  return static_cast<int>(run(a, dtype, false));
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
  return static_cast<int>(run(a, dtype, true));
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
