// The flat optimizer updates over one parameter bucket for Hopper
// (sm_90a): LAMB phase 1 and the LARS/momentum update.
//
// Replaces the TPU kernels of mxnet_tpu/kernels/optimizer_update.py:
//
//   lamb_phase1_pallas (body _lamb1_kernel)
//       g'  = clip(g * rescale)              (clip only when clip > 0)
//       m'  = beta1 * m + (1 - beta1) * g'
//       v'  = beta2 * v + (1 - beta2) * g'^2
//       gw  = (m' * bc1) / (sqrt(v' * bc2) + eps) + wd * w
//   w, g, m, v, m', v' at the parameter dtype (fp32 or bf16), wd (per
//   element, expanded from the per-tensor values) and gw fp32.  The
//   per-step scalars rescale, bc1 and bc2 are read from a 3-float
//   device array, so a CUDA graph that captured the launch takes each
//   step's values (the TPU kernel's scalar operands).  The
//   per-tensor trust ratios (phase 2) are computed from gw outside this
//   kernel, as on the TPU.
//
//   lars_flat_pallas (body _lars_flat_kernel)
//       g'   = clip(g * rescale)
//       step = lr * (g' + wd * w)
//       m'   = momentum * m + sign * step
//       w'   = w - sign * m'
//   w, g, m, w', m' at the parameter dtype (fp32 or bf16); lr (the
//   per-tensor lr times trust ratio), wd and sign (+1 for a LARS tensor,
//   -1 for a skip-list tensor, whose momentum keeps SGD's sign) fp32 per
//   element; rescale is read from a 1-float device array (a graph that
//   captured the launch takes each step's value).  The trust ratios are
//   computed outside this kernel, as on the TPU.
//
// All math is fp32 over the flat (S,) concatenation of a dtype group.
//
// What bounds them: ~12 (LAMB) and ~8 (LARS) flops an element against
// 5 reads + 3 writes and 6 reads + 2 writes, so the bound is bytes:
// 8 * S * 4 over 3.35 TB/s in fp32, for both.
//
// Design (simple first): a grid-stride loop over packs of 4 elements
// (16-byte loads of the fp32 streams) where every pointer is aligned to
// its pack, then a scalar tail; a scalar loop over everything otherwise
// (a bucket can be a view at any offset).  The TPU kernels pad the
// bucket to 128 lanes; here the tail needs no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct Hyper {
  float rescale, bc1, bc2;   // per step, read from the device
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, clip;
};

// the per-step scalars of a launch: rescale, bc1, bc2 from `scalars`
__device__ __forceinline__ Hyper with_step(Hyper h,
                                           const float* __restrict__ s) {
  h.rescale = __ldg(s);
  h.bc1 = __ldg(s + 1);
  h.bc2 = __ldg(s + 2);
  return h;
}

template <typename T>
__device__ __forceinline__ void lamb1(const Hyper& h, T w, T g, T m, T v,
                                      float wd, float* gw, T* nm, T* nv) {
  float gr = to_f32(g) * h.rescale;
  if (h.clip > 0.f) gr = fminf(fmaxf(gr, -h.clip), h.clip);
  const float mf = h.beta1 * to_f32(m) + h.one_minus_beta1 * gr;
  const float vf = h.beta2 * to_f32(v) + h.one_minus_beta2 * gr * gr;
  *gw = (mf * h.bc1) / (sqrtf(vf * h.bc2) + h.eps) + wd * to_f32(w);
  *nm = from_f32<T>(mf);
  *nv = from_f32<T>(vf);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) lamb_phase1_kernel(
    const T* __restrict__ w, const T* __restrict__ g,
    const T* __restrict__ m, const T* __restrict__ v,
    const float* __restrict__ wd, float* __restrict__ gw,
    T* __restrict__ nm, T* __restrict__ nv, int64_t n, Hyper hc,
    const float* __restrict__ scalars) {
  const Hyper h = with_step(hc, scalars);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_vec = n / V;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const Pack<T, V> wi = reinterpret_cast<const Pack<T, V>*>(w)[i];
    const Pack<T, V> gi = reinterpret_cast<const Pack<T, V>*>(g)[i];
    const Pack<T, V> mi = reinterpret_cast<const Pack<T, V>*>(m)[i];
    const Pack<T, V> vi = reinterpret_cast<const Pack<T, V>*>(v)[i];
    const Pack<float, V> di = reinterpret_cast<const Pack<float, V>*>(wd)[i];
    Pack<float, V> go;
    Pack<T, V> mo, vo;
#pragma unroll
    for (int j = 0; j < V; ++j)
      lamb1(h, wi.v[j], gi.v[j], mi.v[j], vi.v[j], di.v[j], &go.v[j],
            &mo.v[j], &vo.v[j]);
    reinterpret_cast<Pack<float, V>*>(gw)[i] = go;
    reinterpret_cast<Pack<T, V>*>(nm)[i] = mo;
    reinterpret_cast<Pack<T, V>*>(nv)[i] = vo;
  }
  // the n % V elements past the last pack
  const int64_t t = n_vec * V + tid;
  if (t < n) lamb1(h, w[t], g[t], m[t], v[t], wd[t], gw + t, nm + t, nv + t);
}

struct LarsHyper {
  float rescale, momentum, clip;   // rescale per step, from the device
};

template <typename T>
__device__ __forceinline__ void lars1(const LarsHyper& h, T w, T g, T m,
                                      float lr, float wd, float sign, T* nw,
                                      T* nm) {
  const float wf = to_f32(w);
  float gr = to_f32(g) * h.rescale;
  if (h.clip > 0.f) gr = fminf(fmaxf(gr, -h.clip), h.clip);
  const float step = lr * (gr + wd * wf);
  const float mf = h.momentum * to_f32(m) + sign * step;
  *nw = from_f32<T>(wf - sign * mf);
  *nm = from_f32<T>(mf);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) lars_flat_kernel(
    const T* __restrict__ w, const T* __restrict__ g,
    const T* __restrict__ m, const float* __restrict__ lr,
    const float* __restrict__ wd, const float* __restrict__ sign,
    T* __restrict__ nw, T* __restrict__ nm, int64_t n, LarsHyper hc,
    const float* __restrict__ rescale) {
  LarsHyper h = hc;
  h.rescale = __ldg(rescale);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_vec = n / V;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const Pack<T, V> wi = reinterpret_cast<const Pack<T, V>*>(w)[i];
    const Pack<T, V> gi = reinterpret_cast<const Pack<T, V>*>(g)[i];
    const Pack<T, V> mi = reinterpret_cast<const Pack<T, V>*>(m)[i];
    const Pack<float, V> li = reinterpret_cast<const Pack<float, V>*>(lr)[i];
    const Pack<float, V> di = reinterpret_cast<const Pack<float, V>*>(wd)[i];
    const Pack<float, V> si =
        reinterpret_cast<const Pack<float, V>*>(sign)[i];
    Pack<T, V> wo, mo;
#pragma unroll
    for (int j = 0; j < V; ++j)
      lars1(h, wi.v[j], gi.v[j], mi.v[j], li.v[j], di.v[j], si.v[j],
            &wo.v[j], &mo.v[j]);
    reinterpret_cast<Pack<T, V>*>(nw)[i] = wo;
    reinterpret_cast<Pack<T, V>*>(nm)[i] = mo;
  }
  // the n % V elements past the last pack
  const int64_t t = n_vec * V + tid;
  if (t < n)
    lars1(h, w[t], g[t], m[t], lr[t], wd[t], sign[t], nw + t, nm + t);
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

int grid_for(int64_t n_items) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n_items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename T>
cudaError_t launch(const void* w, const void* g, const void* m,
                   const void* v, const float* wd, float* gw, void* nm,
                   void* nv, int64_t n, const Hyper& h,
                   const float* scalars, cudaStream_t stream) {
  constexpr int V = 4;
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  const T* mp = static_cast<const T*>(m);
  const T* vp = static_cast<const T*>(v);
  T* nmp = static_cast<T*>(nm);
  T* nvp = static_cast<T*>(nv);
  const unsigned tb = sizeof(T) * V, fb = sizeof(float) * V;
  if (aligned(w, tb) && aligned(g, tb) && aligned(m, tb) && aligned(v, tb) &&
      aligned(nm, tb) && aligned(nv, tb) && aligned(wd, fb) &&
      aligned(gw, fb)) {
    lamb_phase1_kernel<T, V><<<grid_for(n / V), kThreads, 0, stream>>>(
        wp, gp, mp, vp, wd, gw, nmp, nvp, n, h, scalars);
  } else {
    lamb_phase1_kernel<T, 1><<<grid_for(n), kThreads, 0, stream>>>(
        wp, gp, mp, vp, wd, gw, nmp, nvp, n, h, scalars);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lars(const void* w, const void* g, const void* m,
                        const float* lr, const float* wd, const float* sign,
                        void* nw, void* nm, int64_t n, const LarsHyper& h,
                        const float* rescale, cudaStream_t stream) {
  constexpr int V = 4;
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  const T* mp = static_cast<const T*>(m);
  T* nwp = static_cast<T*>(nw);
  T* nmp = static_cast<T*>(nm);
  const unsigned tb = sizeof(T) * V, fb = sizeof(float) * V;
  if (aligned(w, tb) && aligned(g, tb) && aligned(m, tb) &&
      aligned(nw, tb) && aligned(nm, tb) && aligned(lr, fb) &&
      aligned(wd, fb) && aligned(sign, fb)) {
    lars_flat_kernel<T, V><<<grid_for(n / V), kThreads, 0, stream>>>(
        wp, gp, mp, lr, wd, sign, nwp, nmp, n, h, rescale);
  } else {
    lars_flat_kernel<T, 1><<<grid_for(n), kThreads, 0, stream>>>(
        wp, gp, mp, lr, wd, sign, nwp, nmp, n, h, rescale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (w, g, m, v and the new moments).
// `scalars` is a device array of 3 floats: rescale, bc1, bc2.  Returns
// the cudaError_t of the launch (0 = cudaSuccess).  Asynchronous on
// `stream`; allocates nothing.
extern "C" int lamb_phase1_launch(const void* w, const void* g,
                                  const void* m, const void* v,
                                  const float* wd, float* gw, void* nm,
                                  void* nv, int64_t n, const float* scalars,
                                  float beta1, float one_minus_beta1,
                                  float beta2, float one_minus_beta2,
                                  float eps, float clip, int dtype,
                                  void* stream) {
  if (n == 0) return 0;
  const Hyper h = {0.f, 0.f, 0.f, beta1, one_minus_beta1,
                   beta2, one_minus_beta2, eps, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(w, g, m, v, wd, gw, nm, nv, n, h, scalars, s);
    case 1:
      return launch<__nv_bfloat16>(w, g, m, v, wd, gw, nm, nv, n, h,
                                   scalars, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype codes as above (w, g, m and the new weights and momenta).
// `rescale` is a device array of 1 float; clip 0 means none.  Returns the
// cudaError_t of the launch; asynchronous on `stream`; allocates nothing.
extern "C" int lars_flat_launch(const void* w, const void* g, const void* m,
                                const float* lr, const float* wd,
                                const float* sign, void* nw, void* nm,
                                int64_t n, const float* rescale,
                                float momentum, float clip, int dtype,
                                void* stream) {
  if (n == 0) return 0;
  const LarsHyper h = {0.f, momentum, clip};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_lars<float>(w, g, m, lr, wd, sign, nw, nm, n, h, rescale,
                                s);
    case 1:
      return launch_lars<__nv_bfloat16>(w, g, m, lr, wd, sign, nw, nm, n, h,
                                        rescale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* optimizer_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
