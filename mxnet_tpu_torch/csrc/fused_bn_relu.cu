// Fused BatchNorm+ReLU apply passes for Hopper (sm_90a): forward and
// backward.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/fused_bn_relu.py:
//   bn_relu_apply_pallas (body _apply_fwd_kernel)
//       out = relu(x * scale + offset)
//   bn_relu_bwd_pallas   (body _apply_bwd_kernel)
//       dyr = dy where y > 0, else 0
//       xhat = (x - mean) * inv
//       dx = a * (dyr - c1 - xhat * c2)
// over a contiguous channels-last (rows, C) view of an NHWC activation.
// The per-channel vectors (scale, offset; a, mean, inv, c1, c2) arrive
// as fp32 (C,) arrays folded by the caller; the batch statistics and the
// two gradient reductions stay outside these kernels, as they stay in
// XLA outside the Pallas kernels on the TPU.
//
// Layout (all contiguous): x, y, dy, out, dx (rows, C) of one dtype,
// fp32 or bf16; math is fp32 whatever the activation dtype, stores are
// at the activation dtype.
//
// What bounds it: each element costs 2 flops (forward) or ~8 (backward)
// against 2 (forward) or 4 (backward) activation reads and writes, far
// below the card's ridge of ~295 flops per byte, so the bound is bytes:
// forward 2 * rows * C * sizeof(T), backward 4 * rows * C * sizeof(T),
// over 3.35 TB/s.  The design reads each activation element once and
// writes each output once, with 16-byte vector loads and stores (4 fp32
// or 8 bf16 values a thread) where C and the pointers allow it, and a
// scalar path otherwise.  The (C,) vectors are read through the
// read-only data cache (__ldg): at most 5 * 2048 * 4 = 40 KB, they stay
// in L1/L2 while the activation streams past.
//
// Design (simple first): a grid-stride loop over vectors, 256 threads a
// block, a few blocks per SM; no shared memory, no tensor cores (there
// is no matrix product to feed them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

// V values of T moved as one aligned unit (16 bytes when V * sizeof(T)
// is 16).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_relu_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ offset, T* __restrict__ out, int64_t n_vec,
    int channels) {
  const Pack<T, V>* xv = reinterpret_cast<const Pack<T, V>*>(x);
  Pack<T, V>* ov = reinterpret_cast<Pack<T, V>*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_vec; i += stride) {
    const Pack<T, V> in = xv[i];
    // C is a multiple of V, so the V values share one row
    const int c0 = static_cast<int>((i * V) % channels);
    Pack<T, V> res;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = fmaf(to_f32(in.v[j]), __ldg(scale + c0 + j),
                           __ldg(offset + c0 + j));
      res.v[j] = from_f32<T>(fmaxf(y, 0.f));
    }
    ov[i] = res;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_relu_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const T* __restrict__ y, const float* __restrict__ a,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ c1, const float* __restrict__ c2,
    T* __restrict__ dx, int64_t n_vec, int channels) {
  const Pack<T, V>* xv = reinterpret_cast<const Pack<T, V>*>(x);
  const Pack<T, V>* dyv = reinterpret_cast<const Pack<T, V>*>(dy);
  const Pack<T, V>* yv = reinterpret_cast<const Pack<T, V>*>(y);
  Pack<T, V>* dxv = reinterpret_cast<Pack<T, V>*>(dx);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_vec; i += stride) {
    const Pack<T, V> xi = xv[i];
    const Pack<T, V> dyi = dyv[i];
    const Pack<T, V> yi = yv[i];
    const int c0 = static_cast<int>((i * V) % channels);
    Pack<T, V> res;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      const float dyr = to_f32(yi.v[j]) > 0.f ? to_f32(dyi.v[j]) : 0.f;
      const float xhat = (to_f32(xi.v[j]) - __ldg(mean + c)) * __ldg(inv + c);
      res.v[j] = from_f32<T>(
          __ldg(a + c) * (dyr - __ldg(c1 + c) - xhat * __ldg(c2 + c)));
    }
    dxv[i] = res;
  }
}

int grid_for(int64_t n_vec) {
  // enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n_vec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  return static_cast<int>(want < cap ? want : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale,
                       const float* offset, void* out, int64_t rows,
                       int channels, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t n = rows * channels;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (channels % V == 0 && aligned16(x) && aligned16(out)) {
    const int64_t n_vec = n / V;
    bn_relu_fwd_kernel<T, V><<<grid_for(n_vec), kThreads, 0, stream>>>(
        xp, scale, offset, op, n_vec, channels);
  } else {
    bn_relu_fwd_kernel<T, 1><<<grid_for(n), kThreads, 0, stream>>>(
        xp, scale, offset, op, n, channels);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* y,
                       const float* a, const float* mean, const float* inv,
                       const float* c1, const float* c2, void* dx,
                       int64_t rows, int channels, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int64_t n = rows * channels;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  if (channels % V == 0 && aligned16(x) && aligned16(dy) && aligned16(y) &&
      aligned16(dx)) {
    const int64_t n_vec = n / V;
    bn_relu_bwd_kernel<T, V><<<grid_for(n_vec), kThreads, 0, stream>>>(
        xp, dyp, yp, a, mean, inv, c1, c2, dxp, n_vec, channels);
  } else {
    bn_relu_bwd_kernel<T, 1><<<grid_for(n), kThreads, 0, stream>>>(
        xp, dyp, yp, a, mean, inv, c1, c2, dxp, n, channels);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t
// of its launch (0 = cudaSuccess).  Asynchronous on `stream`; allocates
// nothing.
extern "C" int bn_relu_fwd_launch(const void* x, const float* scale,
                                  const float* offset, void* out,
                                  int64_t rows, int channels, int dtype,
                                  void* stream) {
  if (rows == 0 || channels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(x, scale, offset, out, rows, channels, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(x, scale, offset, out, rows,
                                       channels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bn_relu_bwd_launch(const void* x, const void* dy,
                                  const void* y, const float* a,
                                  const float* mean, const float* inv,
                                  const float* c1, const float* c2,
                                  void* dx, int64_t rows, int channels,
                                  int dtype, void* stream) {
  if (rows == 0 || channels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, dy, y, a, mean, inv, c1, c2, dx, rows,
                               channels, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, dy, y, a, mean, inv, c1, c2, dx,
                                       rows, channels, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bn_relu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
