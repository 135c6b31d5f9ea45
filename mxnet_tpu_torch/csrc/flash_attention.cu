// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dk/dv over key tiles, dq over query tiles).
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
// fp32.  Scores, softmax and every accumulation are fp32.  Any seq (the
// edge tiles are bounds-checked) and head_dim <= 128 (padded with zeros
// in shared memory to 32, 64 or 128).
//
// What bounds it: the forward does 4 * bh * seq^2 * d flops (two
// products) and the backward 14 * bh * seq^2 * d (seven) against
// O(bh * seq * d) bytes, so in fp32 on the CUDA cores it is bound by
// operations (67 TFLOP/s), and far above the card's ridge.  The design
// keeps scores out of device memory: a 64-row tile of q (the forward, the
// dq kernel) or of k and v (the dk/dv kernel) stays in shared memory while
// the other operand streams past in 64-row tiles; the running max, sum
// and output accumulator (forward) or the gradient accumulators stay in
// registers.
//
// Design (simple first): 256 threads a block as 16 x 16, each computing
// a 4 x 4 micro-tile of the 64 x 64 score tile (rows ty*4.., keys
// tx+16c) with fp32 FMAs from shared memory, and a 4 x (D/16) tile of
// the 64 x D output.  Row reductions of the online softmax are shuffles
// within a half-warp (the 16 threads of a row group).  No tensor cores,
// no asynchronous copies, no atomics: each dk/dv and dq block owns its
// outputs.  Shared-memory rows are padded by one word so that column
// reads fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

// elements row0 .. row0+63 of a (seq,) fp32 vector, zero outside
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int seq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < seq ? src[row0 + r] : 0.f;
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
// backward, dk/dv: one block per (64 keys, bh), looping over query tiles
// ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, T* __restrict__ dk,
    T* __restrict__ dv, int seq, int d, int heads, float scale,
    int causal) {
  constexpr int kLd = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * kLd;
  float* Qs = Vs + kTile * kLd;
  float* dOs = Qs + kTile * kLd;
  float* Ps = dOs + kTile * kLd;   // [64 q][65]: p
  float* dSs = Ps + kTile * kLdP;  // [64 q][65]: ds
  float* lse_s = dSs + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t base = static_cast<int64_t>(bh) * seq * d;
  const int64_t vbase = static_cast<int64_t>(bh) * seq;
  const float* mask_b =
      mask ? mask + static_cast<int64_t>(bh / heads) * seq * seq : nullptr;

  load_tile<T, D>(Ks, k + base, k0, seq, d);
  load_tile<T, D>(Vs, v + base, k0, seq, d);

  // this thread's rows of dk and dv: keys k0 + ty*4 + r, columns tx+16c
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int num_q = (seq + kTile - 1) / kTile;
  // causal: query tiles wholly above the first key never attend to it
  const int start = causal ? static_cast<int>(blockIdx.x) : 0;
  for (int i = start; i < num_q; ++i) {
    const int q0 = i * kTile;
    __syncthreads();
    load_tile<T, D>(Qs, q + base, q0, seq, d);
    load_tile<T, D>(dOs, dout + base, q0, seq, d);
    load_vec(lse_s, lse + vbase, q0, seq);
    load_vec(delta_s, delta + vbase, q0, seq);
    __syncthreads();

    // score tile: rows are query rows ty*4+r, columns keys tx+16c
    float s[4][4], dp[4][4];
    tile_abt<D>(Qs, Ks, ty, tx, s);
    tile_abt<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qrow = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float p = 0.f, ds = 0.f;
        if (qrow < seq && key < seq) {
          float val = s[r][c] * scale;
          if (!attends(mask_b, causal, seq, qrow, key)) val = kMasked;
          p = expf(val - lse_s[ty * 4 + r]);
          ds = p * (dp[r][c] - delta_s[ty * 4 + r]) * scale;
        }
        Ps[(ty * 4 + r) * kLdP + tx + 16 * c] = p;
        dSs[(ty * 4 + r) * kLdP + tx + 16 * c] = ds;
      }
    }
    __syncthreads();

    // dv[key][:] += sum_q p[q][key] do[q][:]; dk[key][:] += ds[q][key] q[q][:]
#pragma unroll 4
    for (int e = 0; e < kTile; ++e) {
      float a[4], a2[4], b[C], b2[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = Ps[e * kLdP + ty * 4 + r];
        a2[r] = dSs[e * kLdP + ty * 4 + r];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        b[c] = dOs[e * kLd + tx + 16 * c];
        b2[c] = Qs[e * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[r][c] = fmaf(a[r], b[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(a2[r], b2[c], dk_acc[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= seq) continue;
    const int64_t off = base + static_cast<int64_t>(key) * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[off + col] = from_f32<T>(dk_acc[r][c]);
        dv[off + col] = from_f32<T>(dv_acc[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// backward, dq: one block per (64 query rows, bh), looping over key tiles
// ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, T* __restrict__ dq, int seq, int d,
    int heads, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * kLd;
  float* Ks = dOs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* dSs = Vs + kTile * kLd;  // [64 q][65]
  float* lse_s = dSs + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t base = static_cast<int64_t>(bh) * seq * d;
  const int64_t vbase = static_cast<int64_t>(bh) * seq;
  const float* mask_b =
      mask ? mask + static_cast<int64_t>(bh / heads) * seq * seq : nullptr;

  load_tile<T, D>(Qs, q + base, q0, seq, d);
  load_tile<T, D>(dOs, dout + base, q0, seq, d);
  load_vec(lse_s, lse + vbase, q0, seq);
  load_vec(delta_s, delta + vbase, q0, seq);

  float acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;

  int num_kv = (seq + kTile - 1) / kTile;
  if (causal) num_kv = min(num_kv, static_cast<int>(blockIdx.x) + 1);
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k + base, k0, seq, d);
    load_tile<T, D>(Vs, v + base, k0, seq, d);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(Qs, Ks, ty, tx, s);
    tile_abt<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qrow = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        float ds = 0.f;
        if (qrow < seq && key < seq) {
          float val = s[r][c] * scale;
          if (!attends(mask_b, causal, seq, qrow, key)) val = kMasked;
          const float p = expf(val - lse_s[ty * 4 + r]);
          ds = p * (dp[r][c] - delta_s[ty * 4 + r]) * scale;
        }
        dSs[(ty * 4 + r) * kLdP + tx + 16 * c] = ds;
      }
    }
    __syncthreads();

    // dq[q][:] += sum_key ds[q][key] k[key][:]
#pragma unroll 4
    for (int e = 0; e < kTile; ++e) {
      float a[4], b[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = dSs[(ty * 4 + r) * kLdP + e];
#pragma unroll
      for (int c = 0; c < C; ++c) b[c] = Ks[e * kLd + tx + 16 * c];
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
    T* row = dq + base + static_cast<int64_t>(qrow) * d;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tx + 16 * c;
      if (col < d) row[col] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdP + 2 * kTile);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const float* mask;
  void* out;   // forward: out; backward: dq
  float* lse;  // forward only
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

template <typename T, int D>
cudaError_t launch_bwd(const Args& a) {
  const size_t smem_kv = dkv_smem<D>();
  const size_t smem_q = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kTile - 1) / kTile, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem_kv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, a.mask, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.seq,
      a.d, a.heads, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, a.mask, static_cast<T*>(a.out), a.seq, a.d, a.heads,
      a.scale, a.causal);
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
// is 0 or 1.  Each returns the cudaError_t of its launches (0 =
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
                                void* dq, void* dk, void* dv, int bh,
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
