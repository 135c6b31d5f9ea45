// Decode-step paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/paged_attention.py ::
// paged_attention_pallas (body _decode_kernel): one query token per slot
// attends over the K/V its block table names in the paged cache, with an
// online softmax across the table's blocks and positions >= context
// length masked.
//
// Layout (all contiguous):
//   q            (slots, heads, d)                  fp32 or bf16
//   k/v cache    (num_blocks, block_size, heads, d) fp32 or bf16
//   block_tables (slots, max_blocks)                int32
//   context_lens (slots,)                           int32
//   out          (slots, heads, d)                  dtype of q
// Table entries must lie in [0, num_blocks), as the cache manager hands
// them out; a context past max_blocks * block_size reads the whole table.
//
// What bounds it: the decode step reads ctx * heads * d * 2 cache values
// and does 4 flops on each, far below the card's ridge of ~295 flops per
// byte, so the bound is bytes: the live K/V rows read once.  The design
// reads only live rows (the table is walked for ceil(ctx / block_size)
// blocks, the dead tail of the last block is skipped), each exactly once,
// with coalesced loads: a warp reads one key row, a thread block reads a
// value row across its threads.  Accumulation is fp32 whatever the cache
// dtype.
//
// Design (simple first): one thread block per (head, slot).  For each
// table block, warp w scores key rows w, w + WARPS, ... with a
// warp-shuffle dot product into shared memory; then every thread takes
// the block max, thread r writes p_r = exp(s_r - m_new), and thread i
// rescales and accumulates output dim i.  No wgmma or TMA: with one query
// row per head there is no matrix product to feed them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ k_cache,
    const TC* __restrict__ v_cache, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, TQ* __restrict__ out, int heads,
    int d, int block_size, int max_blocks, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // d: the query row, fp32
  float* acc = q_s + d;              // d: running output accumulator
  float* s_s = acc + d;              // block_size: this block's scores
  float* p_s = s_s + block_size;     // block_size: exp(s - m_new)

  const int h = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t qo = (static_cast<size_t>(slot) * heads + h) * d;
  for (int i = tid; i < d; i += kThreads) {
    q_s[i] = to_f32(q[qo + i]);
    acc[i] = 0.f;
  }
  __syncthreads();

  const int ctx = context_lens[slot];
  int n_blocks = ctx > 0 ? (ctx + block_size - 1) / block_size : 0;
  n_blocks = min(n_blocks, max_blocks);
  const int* table = block_tables + static_cast<size_t>(slot) * max_blocks;
  const size_t row_stride = static_cast<size_t>(heads) * d;
  const size_t block_stride = row_stride * block_size;

  float m = kNegInf;
  float l = 0.f;
  for (int j = 0; j < n_blocks; ++j) {
    const size_t base = table[j] * block_stride + static_cast<size_t>(h) * d;
    const int live = min(block_size, ctx - j * block_size);
    const TC* kb = k_cache + base;
    const TC* vb = v_cache + base;

    for (int r = warp; r < live; r += kWarps) {
      const TC* kr = kb + r * row_stride;
      float part = 0.f;
      for (int i = lane; i < d; i += 32) part += q_s[i] * to_f32(kr[i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s_s[r] = part * scale;
    }
    __syncthreads();

    float bmax = kNegInf;
    for (int r = 0; r < live; ++r) bmax = fmaxf(bmax, s_s[r]);
    const float m_new = fmaxf(m, bmax);
    for (int r = tid; r < live; r += kThreads) p_s[r] = expf(s_s[r] - m_new);
    __syncthreads();

    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int r = 0; r < live; ++r) psum += p_s[r];
    for (int i = tid; i < d; i += kThreads) {
      float a = acc[i] * alpha;
      for (int r = 0; r < live; ++r) a += p_s[r] * to_f32(vb[r * row_stride + i]);
      acc[i] = a;
    }
    l = alpha * l + psum;
    m = m_new;
    // s_s / p_s are rewritten by the next block
    __syncthreads();
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int i = tid; i < d; i += kThreads) out[qo + i] = from_f32<TQ>(acc[i] * inv);
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* ctx, void* out, int slots,
                   int heads, int d, int block_size, int max_blocks,
                   float scale, cudaStream_t stream) {
  const dim3 grid(heads, slots);
  const size_t smem = sizeof(float) * (2 * d + 2 * block_size);
  paged_attention_kernel<TQ, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), tables, ctx, static_cast<TQ*>(out), heads,
      d, block_size, max_blocks, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).  Asynchronous on `stream`; allocates nothing.
extern "C" int paged_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const int* block_tables, const int* context_lens, void* out, int slots,
    int heads, int d, int block_size, int max_blocks, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  if (slots == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = q_dtype * 2 + kv_dtype;
  switch (code) {
    case 0:
      return launch<float, float>(q, k_cache, v_cache, block_tables,
                                  context_lens, out, slots, heads, d,
                                  block_size, max_blocks, scale, s);
    case 1:
      return launch<float, __nv_bfloat16>(q, k_cache, v_cache, block_tables,
                                          context_lens, out, slots, heads, d,
                                          block_size, max_blocks, scale, s);
    case 2:
      return launch<__nv_bfloat16, float>(q, k_cache, v_cache, block_tables,
                                          context_lens, out, slots, heads, d,
                                          block_size, max_blocks, scale, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, k_cache, v_cache, block_tables, context_lens, out, slots, heads,
          d, block_size, max_blocks, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
