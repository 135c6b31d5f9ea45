// LayerNorm forward over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/layernorm.py:
//   layernorm_fwd_pallas (body _ln_kernel)
//       mean = mean(x), var = mean((x - mean)^2)
//       out = (x - mean) * rsqrt(var + eps) * gamma + beta
// over a contiguous (rows, dim) view, with fp32 statistics whatever the
// input dtype and the output stored at the input dtype.  gamma and beta
// arrive as fp32 (dim,) vectors.
//
// What bounds it: ~8 flops an element against one read and one write of
// the activation, far below the card's ridge, so the bound is bytes:
// 2 * rows * dim * sizeof(T) over 3.35 TB/s (plus the two vectors).
//
// Design (simple first): one warp per row, eight rows a block.  The warp
// makes three passes over its row -- the sum, the centred sum of
// squares (two-pass statistics, as the TPU kernel), and the normalised
// write -- with 16-byte vector loads where dim and the pointers allow it
// and a scalar path otherwise.  Only the first pass reaches device
// memory: a row of BERT-base (768 fp32 values, 3 KB) stays in L1 for the
// second and third.  Any rows and dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) layernorm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int64_t rows,
    int dim, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const Pack<T, V>* xv = reinterpret_cast<const Pack<T, V>*>(x + row * dim);
  Pack<T, V>* ov = reinterpret_cast<Pack<T, V>*>(out + row * dim);
  const int n_vec = dim / V;

  float sum = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    const Pack<T, V> p = xv[i];
#pragma unroll
    for (int j = 0; j < V; ++j) sum += to_f32(p.v[j]);
  }
  const float mean = warp_sum(sum) / dim;

  float sq = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    const Pack<T, V> p = xv[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = to_f32(p.v[j]) - mean;
      sq += c * c;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / dim + eps);

  for (int i = lane; i < n_vec; i += 32) {
    const Pack<T, V> p = xv[i];
    Pack<T, V> res;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = i * V + j;
      res.v[j] = from_f32<T>((to_f32(p.v[j]) - mean) * inv * __ldg(gamma + c) +
                             __ldg(beta + c));
    }
    ov[i] = res;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* out, int64_t rows, int dim, float eps,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const int grid = static_cast<int>(blocks);
  if (dim % V == 0 && aligned16(x) && aligned16(out)) {
    layernorm_fwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
        xp, gamma, beta, op, rows, dim, eps);
  } else {
    layernorm_fwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        xp, gamma, beta, op, rows, dim, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (0 = cudaSuccess).  Asynchronous on `stream`; allocates nothing.
extern "C" int layernorm_fwd_launch(const void* x, const float* gamma,
                                    const float* beta, void* out,
                                    int64_t rows, int dim, float eps,
                                    int dtype, void* stream) {
  if (rows == 0 || dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, gamma, beta, out, rows, dim, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, gamma, beta, out, rows, dim, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
