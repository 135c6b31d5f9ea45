// Decode-step paged attention for Hopper (sm_90a), split across the
// context (flash-decoding).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/paged_attention.py ::
// paged_attention_pallas (body _decode_kernel): one query token per slot
// attends over the K/V its block table names in the paged cache, with an
// online softmax across the table's blocks and positions >= context
// length masked.  A slot with context 0 gives zeros, as the TPU kernel.
//
// Layout (all contiguous):
//   q            (slots, heads, d)                  fp32 or bf16
//   k/v cache    (num_blocks, block_size, heads, d) fp32 or bf16
//   block_tables (slots, max_blocks)                int32
//   context_lens (slots,)                           int32
//   out          (slots, heads, d)                  dtype of q
//   partials     (slots, max_parts, heads, d + 2)   fp32 scratch
//   tickets      (slots, heads)                     int32, zero between calls
// Table entries must lie in [0, num_blocks), as the cache manager hands
// them out; a context past max_blocks * block_size reads the whole table.
//
// What bounds it: the decode step reads ctx * heads * d * 2 cache values
// and does 4 flops on each, far below the card's ridge of ~295 flops per
// byte, so the bound is bytes: the live K/V rows read once.  At the
// decode path's shapes that is a few MB, a couple of microseconds at
// 3.35 TB/s, so what costs is filling 132 SMs and keeping enough loads in
// flight to cover the memory latency; one block walking a slot's whole
// table serially does neither.
//
// Design: the context is cut into partitions of `part_blocks` table
// blocks (the wrapper picks ~64 tokens), one 128-thread block per
// (partition, head, slot).  A block first issues the loads that do not
// depend on the context (its table entries, q, the context length), then
// groups of G lanes each take rows gid, gid + groups, ...: eight rows a
// step, whose K and V vectors (16-byte loads of 4 fp32 or 8 bf16 values
// where the rows are aligned, scalar loads otherwise; neighbouring lanes
// on neighbouring addresses) are all in flight at once.  A shuffle
// reduction inside the group gives the scores, and each group keeps its
// own online softmax (m, l) and p V row, so no barrier of the block
// stands between a step's loads and their use; at the decode path's
// shapes a partition is one step.  The groups' results are merged in a
// fixed order.  Every sum is fp32.
//
// Merge: each block writes (acc[d], m, l) to the scratch, and the last
// block of its (slot, head) to arrive, counted by an atomic ticket,
// merges them, out = sum_p e^(m_p - M) acc_p / sum_p e^(m_p - M) l_p,
// and sets the ticket back to 0 for the next call (a slot with one
// partition takes the same path: its first ticket is the last).  One
// launch per call; partitions past a slot's context exit at once and are
// never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kInFlight = 8;  // key/value rows a lane group loads at once

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

// VEC consecutive values at p as fp32: one 16-byte load for 4 fp32 or 8
// bf16 values (p 16-byte aligned), else one scalar load
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(VEC == 1, "fp32 rows load 1 or 4 values");
    out[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair;
      *reinterpret_cast<uint32_t*>(&pair) = w[i];
      const float2 f = __bfloat1622float2(pair);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 1, "bf16 rows load 1 or 8 values");
    out[0] = __bfloat162float(p[0]);
  }
}

// the sum over the G lanes of a lane group (G a power of two <= 32)
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* tables;
  const int* ctx;
  void* out;
  float* partials;
  int* tickets;
  int heads, d, block_size, max_blocks, part_blocks, max_parts;
  float scale;
};

// block (partition, head, slot); VEC values per load, G lanes per row
template <typename TQ, typename TC, int VEC, int G>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params a) {
  constexpr int kGroups = kThreads / G;  // lane groups of the block
  constexpr int kStep = kGroups * kInFlight;
  const int p = blockIdx.x;
  const int h = blockIdx.y;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int d = a.d;
  const int bs = a.block_size;

  // issue the loads that do not depend on the context first
  const int first_blk = p * a.part_blocks;
  const int* table = a.tables + static_cast<size_t>(slot) * a.max_blocks;
  const int tbl = tid < a.part_blocks && first_blk + tid < a.max_blocks
                      ? table[first_blk + tid]
                      : 0;
  const size_t qo = (static_cast<size_t>(slot) * a.heads + h) * d;
  const TQ* q = static_cast<const TQ*>(a.q);
  const float q0 = tid < d ? to_f32(q[qo + tid]) : 0.f;
  const int ctx = a.ctx[slot];

  const int n_tok = ctx <= 0 ? 0 : min(ctx, a.max_blocks * bs);
  const int part_tok = a.part_blocks * bs;
  const int n_parts = (n_tok + part_tok - 1) / part_tok;
  TQ* out = static_cast<TQ*>(a.out);
  if (n_parts == 0) {  // context 0: zeros, as the TPU kernel
    if (p == 0)
      for (int i = tid; i < d; i += kThreads) out[qo + i] = from_f32<TQ>(0.f);
    return;
  }
  if (p >= n_parts) return;

  extern __shared__ float smem[];
  float* q_s = smem;                    // d
  float* acc_s = q_s + d;               // kGroups * d: each group's p V
  float* m_s = acc_s + kGroups * d;     // kGroups
  float* l_s = m_s + kGroups;           // kGroups
  int* tbl_s = reinterpret_cast<int*>(l_s + kGroups);  // part_blocks
  __shared__ int last;

  const int n = min(part_tok, n_tok - p * part_tok);  // live rows here
  if (tid < d) q_s[tid] = q0;
  for (int i = tid + kThreads; i < d; i += kThreads) q_s[i] = to_f32(q[qo + i]);
  if (tid < a.part_blocks) tbl_s[tid] = tbl;
  for (int i = tid + kThreads; i < a.part_blocks; i += kThreads)
    tbl_s[i] = first_blk + i < a.max_blocks ? table[first_blk + i] : 0;
  const int gid = tid / G;
  const int lg = tid % G;
  float* acc = acc_s + gid * d;  // this group's row; lane lg owns its vectors
  for (int i = lg; i < d; i += G) acc[i] = 0.f;
  __syncthreads();

  const int nvec = d / VEC;
  const size_t row_stride = static_cast<size_t>(a.heads) * d;
  const TC* kbase = static_cast<const TC*>(a.k) + static_cast<size_t>(h) * d;
  const TC* vbase = static_cast<const TC*>(a.v) + static_cast<size_t>(h) * d;

  // online softmax per lane group over rows base + gid + u * kGroups: the
  // K and V rows of a step load together, and no barrier of the block
  // stands between a step's loads and its use
  float m = kNegInf;
  float l = 0.f;
  for (int base = 0; base < n; base += kStep) {
    size_t off[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int r = min(base + gid + u * kGroups, n - 1);
      off[u] = (static_cast<size_t>(tbl_s[r / bs]) * bs + r % bs) * row_stride;
    }
    // the first column vector of K and V, then the rest of K
    const int c0 = min(lg, nvec - 1);
    float kv[kInFlight][VEC], vv[kInFlight][VEC];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      load_f32<VEC>(kbase + off[u] + c0 * VEC, kv[u]);
      load_f32<VEC>(vbase + off[u] + c0 * VEC, vv[u]);
    }
    float part[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      part[u] = 0.f;
      if (lg < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[u] = fmaf(q_s[c0 * VEC + e], kv[u][e], part[u]);
    }
    for (int c = lg + G; c < nvec; c += G) {
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        load_f32<VEC>(kbase + off[u] + c * VEC, kv[u]);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part[u] = fmaf(q_s[c * VEC + e], kv[u][e], part[u]);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const float dot = group_sum<G>(part[u]);  // every lane shuffles
      part[u] = base + gid + u * kGroups < n ? dot * a.scale : kNegInf;
      m_new = fmaxf(m_new, part[u]);
    }
    // an empty step keeps m: alpha is 1 and every p is 0
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const bool live = base + gid + u * kGroups < n;
      part[u] = live ? expf(part[u] - m_new) : 0.f;  // p
      l += part[u];
    }
    m = m_new;
    if (lg < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float o = acc[c0 * VEC + e] * alpha;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) o = fmaf(part[u], vv[u][e], o);
        acc[c0 * VEC + e] = o;
      }
    for (int c = lg + G; c < nvec; c += G) {
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        load_f32<VEC>(vbase + off[u] + c * VEC, vv[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float o = acc[c * VEC + e] * alpha;
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) o = fmaf(part[u], vv[u][e], o);
        acc[c * VEC + e] = o;
      }
    }
  }
  if (lg == 0) {
    m_s[gid] = m;
    l_s[gid] = l;
  }
  __syncthreads();

  // the partition's (m, l, acc) from its groups'
  float mx = kNegInf;
  for (int g = 0; g < kGroups; ++g) mx = fmaxf(mx, m_s[g]);
  float sum = 0.f;
  for (int g = 0; g < kGroups; ++g) sum += expf(m_s[g] - mx) * l_s[g];

  const size_t rec = static_cast<size_t>(d) + 2;
  float* mine =
      a.partials +
      ((static_cast<size_t>(slot) * a.max_parts + p) * a.heads + h) * rec;
  for (int i = tid; i < d; i += kThreads) {
    float o = 0.f;
    for (int g = 0; g < kGroups; ++g)
      o = fmaf(expf(m_s[g] - mx), acc_s[g * d + i], o);
    mine[i] = o;
  }
  if (tid == 0) {
    mine[d] = mx;
    mine[d + 1] = sum;
  }
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + static_cast<size_t>(slot) * a.heads + h;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of (slot, head) merges the partitions
  const float* recs =
      a.partials +
      (static_cast<size_t>(slot) * a.max_parts * a.heads + h) * rec;
  const size_t pstride = static_cast<size_t>(a.heads) * rec;
  float big = kNegInf;
  for (int pp = 0; pp < n_parts; ++pp)
    big = fmaxf(big, __ldcg(recs + pp * pstride + d));
  float total = 0.f;
  for (int pp = 0; pp < n_parts; ++pp) {
    const float* r = recs + pp * pstride;
    total += expf(__ldcg(r + d) - big) * __ldcg(r + d + 1);
  }
  const float inv = 1.f / fmaxf(total, 1e-30f);
  for (int i = tid; i < d; i += kThreads) {
    float o = 0.f;
    for (int pp = 0; pp < n_parts; ++pp) {
      const float* r = recs + pp * pstride;
      o += expf(__ldcg(r + d) - big) * __ldcg(r + i);
    }
    out[qo + i] = from_f32<TQ>(o * inv);
  }
  if (tid == 0) *ticket = 0;  // ready for the next call on this stream
}

template <typename TQ, typename TC, int VEC, int G>
cudaError_t launch_g(const Params& a, int slots, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const size_t smem = sizeof(float) * (a.d + kGroups * (a.d + 2)) +
                      sizeof(int) * a.part_blocks;
  auto kernel = paged_attention_kernel<TQ, TC, VEC, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.max_parts, a.heads, slots);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// G: the least power of two >= the vectors of a row, within [4, 32]
template <typename TQ, typename TC, int VEC>
cudaError_t launch_vec(const Params& a, int slots, cudaStream_t stream) {
  const int nvec = a.d / VEC;
  if (nvec <= 4) return launch_g<TQ, TC, VEC, 4>(a, slots, stream);
  if (nvec <= 8) return launch_g<TQ, TC, VEC, 8>(a, slots, stream);
  if (nvec <= 16) return launch_g<TQ, TC, VEC, 16>(a, slots, stream);
  return launch_g<TQ, TC, VEC, 32>(a, slots, stream);
}

template <typename TQ, typename TC>
cudaError_t launch(const Params& a, int slots, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TC);
  const bool aligned = reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.v) % 16 == 0 &&
                       a.d % kVec == 0;
  return aligned ? launch_vec<TQ, TC, kVec>(a, slots, stream)
                 : launch_vec<TQ, TC, 1>(a, slots, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `partials` holds slots *
// max_parts * heads * (d + 2) floats, max_parts = ceil(max_blocks /
// part_blocks); `tickets` slots * heads ints, zero before the call and
// left zero after it.  Returns the cudaError_t of the launch (0 =
// cudaSuccess).  Asynchronous on `stream`; allocates nothing.
extern "C" int paged_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* block_tables, const int* context_lens, void* out,
    float* partials, int* tickets, int slots, int heads, int d,
    int block_size, int max_blocks, int part_blocks, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (slots == 0) return 0;
  if (part_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params a;
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.tables = block_tables;
  a.ctx = context_lens;
  a.out = out;
  a.partials = partials;
  a.tickets = tickets;
  a.heads = heads;
  a.d = d;
  a.block_size = block_size;
  a.max_blocks = max_blocks;
  a.part_blocks = part_blocks;
  a.max_parts = (max_blocks + part_blocks - 1) / part_blocks;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype * 2 + kv_dtype) {
    case 0:
      return launch<float, float>(a, slots, s);
    case 1:
      return launch<float, __nv_bfloat16>(a, slots, s);
    case 2:
      return launch<__nv_bfloat16, float>(a, slots, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(a, slots, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
