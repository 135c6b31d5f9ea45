// LayerNorm forward over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel of mxnet_tpu/ops/pallas/layernorm.py:
//   layernorm_fwd_pallas (body _ln_kernel)
//       mean = mean(x), var = mean((x - mean)^2)
//       out = (x - mean) * rsqrt(var + eps) * gamma + beta
// over a contiguous (rows, dim) view, with fp32 statistics whatever the
// input dtype (two passes: the mean, then the mean of the centred
// squares), gamma and beta applied in fp32, and the output stored at the
// input dtype with round-to-nearest.  gamma and beta arrive as fp32
// (dim,) vectors.
//
// What bounds it: ~8 flops an element against one read and one write of
// the activation, far below the card's ridge, so the bound is bytes:
// 2 * rows * dim * sizeof(T) over 3.35 TB/s (plus the two vectors).
//
// The first design (one warp a row, eight rows a block, three passes over
// the row) stayed under half of that bound in bf16, held back by three
// things, each answered here:
//   1. gamma and beta were read with two scalar loads an element for
//      every row: 16 loads beside each 16-byte load of x in bf16, so the
//      kernel was bound by load instructions, not bytes.  Now a lane
//      always owns the same columns, so it loads its slice of gamma and
//      beta once, as 16-byte vectors, into registers before its row loop
//      (up to kGammaRegPacks packs a lane; above that, 16-byte vector
//      loads a row, from L1).
//   2. Three passes with a reduction between each pair left a warp with
//      one row's first-pass loads in flight and none while it reduced and
//      wrote.  Now the row is held in registers (each lane keeps its
//      dim / (32 V) packs of V = 16 / sizeof(T) elements), both statistics
//      come from registers, and device memory is read once.  The next
//      rows are already on their way while a row is reduced: a per-warp
//      ring of row slots in shared memory, each filled by a 1-D TMA bulk
//      copy that completes on its own mbarrier.  (A register double
//      buffer, the next row's loads issued into a second set of
//      registers, measured 3.5-5% slower at every BERT shape on the
//      H100, so the ring is the design.)
//   3. One block of 8 warps per 8 rows made ~3.9 waves with a partial
//      last wave, every block reloading gamma and beta.  Now the grid is
//      persistent: the SM count times the blocks that fit on an SM
//      (cached per kernel and device), each warp walking rows warp_id,
//      warp_id + total_warps, ...
//
// Routes, chosen by the launcher from the shape and the pointers, never
// a plain version:
//   ring             dim a whole number of 16-byte packs, at most 512 packs
//                    a row (4,096 bf16, 2,048 fp32), every pointer 16-byte
//                    aligned;
//   generic          everything else (dim not a whole number of packs, a
//                    misaligned pointer, dim above the cap, dim 1): one warp
//                    a row, three passes over the row (L1 holds it for the
//                    second and third), 16-byte packs of x with gamma and
//                    beta as 16-byte vectors where dim and the pointers
//                    allow it, scalars otherwise.
// No launch synchronises or allocates, so every route captures into a
// CUDA graph.  The dynamic-shared-memory limit and the occupancy are set
// and read once per kernel and device, outside any stream, at the first
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPacksPerLane = 16;  // 512 packs a row: 4,096 bf16, 2,048 fp32
constexpr int kGammaRegPacks = 8;     // gamma and beta in registers up to here
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 96 * 1024;  // a block's ring, before the floor of 2
constexpr int kBarBytes = kWarps * kMaxStages * 8;  // 256, keeps slots aligned
constexpr int kSlotAlign = 128;

enum Route { kRing = 1, kGeneric = 2 };

// ---- element conversions -------------------------------------------------

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

// A 16-byte pack of V elements, unpacked to and packed from fp32.
template <typename T>
struct Pack16;

template <>
struct Pack16<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void unpack(const uint4& p, float* f) {
    f[0] = __uint_as_float(p.x);
    f[1] = __uint_as_float(p.y);
    f[2] = __uint_as_float(p.z);
    f[3] = __uint_as_float(p.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static float2 half_of(uint32_t w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, 4);
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static uint32_t word_of(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
  __device__ __forceinline__ static void unpack(const uint4& p, float* f) {
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = half_of(w[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(word_of(f[0], f[1]), word_of(f[2], f[3]),
                      word_of(f[4], f[5]), word_of(f[6], f[7]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- mbarrier and bulk-copy helpers (PTX) --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this warp's earlier generic-proxy reads of a slot before the
// async-proxy (TMA) write that refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the row held in registers (ring route) ------------------------------

// What a lane keeps of gamma and beta: its P packs in registers (kRegs),
// or nothing, reading 16-byte vectors a row.
template <int P, int V, bool kRegs>
struct Affine {
  float g[kRegs ? P : 1][V];
  float b[kRegs ? P : 1][V];

  __device__ __forceinline__ static void load_vec(const float* src, float* d) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
      d[j] = v.x;
      d[j + 1] = v.y;
      d[j + 2] = v.z;
      d[j + 3] = v.w;
    }
  }

  __device__ __forceinline__ void init(const float* gamma, const float* beta,
                                       int lane, int n_packs) {
    if constexpr (kRegs) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = lane + 32 * p;
        if (i < n_packs) {
          load_vec(gamma + i * V, g[p]);
          load_vec(beta + i * V, b[p]);
        }
      }
    }
  }

  // (gamma, beta) of pack p (column pack i) into gv, bv
  __device__ __forceinline__ void get(int p, int i, const float* gamma,
                                      const float* beta, float* gv,
                                      float* bv) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        gv[j] = g[p][j];
        bv[j] = b[p][j];
      }
    } else {
      load_vec(gamma + i * V, gv);
      load_vec(beta + i * V, bv);
    }
  }
};

// Normalise one row held as this lane's P packs and store it.
template <typename T, int P, bool kRegs>
__device__ __forceinline__ void normalise_row(
    const uint4 (&v)[P], const Affine<P, Pack16<T>::V, kRegs>& aff,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    uint4* __restrict__ orow, int lane, int n_packs, int dim, float eps) {
  constexpr int V = Pack16<T>::V;
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (lane + 32 * p < n_packs) {
      float f[V];
      Pack16<T>::unpack(v[p], f);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += f[j];
    }
  }
  const float mean = warp_sum(sum) / dim;

  float sq = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (lane + 32 * p < n_packs) {
      float f[V];
      Pack16<T>::unpack(v[p], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = f[j] - mean;
        sq += c * c;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / dim + eps);

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = lane + 32 * p;
    if (i < n_packs) {
      float f[V], gv[V], bv[V];
      Pack16<T>::unpack(v[p], f);
      aff.get(p, i, gamma, beta, gv, bv);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] - mean) * inv * gv[j] + bv[j];
      orow[i] = Pack16<T>::pack(f);
    }
  }
}

// Ring route: each warp owns `stages` row slots of `slot_stride` bytes in
// dynamic shared memory and one mbarrier a slot.  Lane 0 keeps up to
// `stages` rows in flight as TMA bulk copies; the warp waits on a slot's
// barrier (parity = how many times the slot has been filled before, mod
// 2), reads its packs into registers, and lane 0 refills the slot with
// the row `stages` ahead once every lane has read it.
template <typename T, int P, bool kRegs>
__global__ void __launch_bounds__(kThreads) layernorm_fwd_kernel_ring(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int64_t rows,
    int dim, float eps, int stages, int slot_stride) {
  constexpr int V = Pack16<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t tw = static_cast<int64_t>(gridDim.x) * kWarps;
  if (gw >= rows) return;  // the whole warp leaves; it owns no barrier in use
  const int64_t mine = (rows - gw + tw - 1) / tw;
  const int n_packs = dim / V;
  const uint32_t row_bytes = static_cast<uint32_t>(dim) * sizeof(T);

  const uint32_t bar0 = smem_addr(smem) + warp * kMaxStages * 8;
  unsigned char* ring = smem + kBarBytes +
                        static_cast<size_t>(warp) * stages * slot_stride;
  const uint32_t ring0 = smem_addr(ring);

  auto issue = [&](int64_t k, int slot) {
    const uint32_t bar = bar0 + slot * 8;
    mbar_expect_tx(bar, row_bytes);
    bulk_g2s(ring0 + slot * slot_stride, x + (gw + k * tw) * dim, row_bytes,
             bar);
  };

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + s * 8, 1);
    mbar_init_fence();
    const int64_t first = mine < stages ? mine : stages;
    for (int64_t k = 0; k < first; ++k) issue(k, static_cast<int>(k));
  }
  __syncwarp();

  Affine<P, V, kRegs> aff;
  aff.init(gamma, beta, lane, n_packs);

  int slot = 0;
  uint32_t parity = 0;
  for (int64_t k = 0; k < mine; ++k) {
    mbar_wait(bar0 + slot * 8, parity);
    const uint4* src =
        reinterpret_cast<const uint4*>(ring + slot * slot_stride);
    uint4 v[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (lane + 32 * p < n_packs) v[p] = src[lane + 32 * p];
    __syncwarp();
    if (lane == 0 && k + stages < mine) {
      fence_proxy_async();
      issue(k + stages, slot);
    }
    uint4* orow = reinterpret_cast<uint4*>(out + (gw + k * tw) * dim);
    normalise_row<T, P, kRegs>(v, aff, gamma, beta, orow, lane, n_packs, dim,
                               eps);
    if (++slot == stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
}

// ---- generic route -------------------------------------------------------

// One warp a row, three passes (sum, centred squares, normalised write);
// V = 16 / sizeof(T) with 16-byte packs of x and 16-byte vectors of gamma
// and beta, or V = 1 with scalars.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) layernorm_fwd_kernel_generic(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int64_t rows,
    int dim, float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * dim;
  T* orow = out + row * dim;
  const int n_vec = dim / V;

  auto load = [&](int i, float* f) {
    if constexpr (V == 1) {
      f[0] = to_f32(xr[i]);
    } else {
      Pack16<T>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
    }
  };

  float sum = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    float f[V];
    load(i, f);
#pragma unroll
    for (int j = 0; j < V; ++j) sum += f[j];
  }
  const float mean = warp_sum(sum) / dim;

  float sq = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    float f[V];
    load(i, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c = f[j] - mean;
      sq += c * c;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / dim + eps);

  for (int i = lane; i < n_vec; i += 32) {
    float f[V], gv[V], bv[V];
    load(i, f);
    if constexpr (V == 1) {
      gv[0] = __ldg(gamma + i);
      bv[0] = __ldg(beta + i);
    } else {
      Affine<1, V, false>::load_vec(gamma + i * V, gv);
      Affine<1, V, false>::load_vec(beta + i * V, bv);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = (f[j] - mean) * inv * gv[j] + bv[j];
    if constexpr (V == 1) {
      orow[i] = from_f32<T>(f[0]);
    } else {
      reinterpret_cast<uint4*>(orow)[i] = Pack16<T>::pack(f);
    }
  }
}

// ---- host side -----------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Resident blocks of `fn` on the whole card at `smem` dynamic bytes,
// computed once per (kernel, shared memory, device).  The first call for
// a kernel on a device also raises its dynamic-shared-memory limit to
// the device's opt-in maximum.  Host-side only: no stream operation, so
// it may run while a stream is being captured.
cudaError_t persistent_blocks(const void* fn, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int smem, device, blocks;
  };
  static std::mutex mu;
  static Entry cache[128];
  static int n_cache = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool seen = false;
  for (int i = 0; i < n_cache; ++i) {
    if (cache[i].fn == fn && cache[i].device == device) {
      seen = true;
      if (cache[i].smem == smem) {
        *blocks = cache[i].blocks;
        return cudaSuccess;
      }
    }
  }
  if (!seen && smem > 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (n_cache < 128) cache[n_cache++] = Entry{fn, smem, device, *blocks};
  return cudaSuccess;
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  void* out;
  int64_t rows;
  int dim;
  float eps;
  cudaStream_t stream;
};

int grid_for(int64_t rows, int resident) {
  const int64_t need = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(need < resident ? need : resident);
}

template <typename T, int P>
cudaError_t launch_ring(const Args& a) {
  constexpr bool kRegs = P <= kGammaRegPacks;
  const void* fn =
      reinterpret_cast<const void*>(&layernorm_fwd_kernel_ring<T, P, kRegs>);
  const int row_bytes = a.dim * static_cast<int>(sizeof(T));
  const int stride = (row_bytes + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
  int stages = kRingBudget / (kWarps * stride);
  stages = stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
  const int smem = kBarBytes + kWarps * stages * stride;
  int resident = 0;
  const cudaError_t err = persistent_blocks(fn, smem, &resident);
  if (err != cudaSuccess) return err;
  layernorm_fwd_kernel_ring<T, P, kRegs>
      <<<grid_for(a.rows, resident), kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.x), a.gamma, a.beta, static_cast<T*>(a.out),
          a.rows, a.dim, a.eps, stages, stride);
  return cudaGetLastError();
}

// Packs a lane holds, rounded up to an instantiated count.
int packs_per_lane(int n_packs) {
  const int need = (n_packs + 31) / 32;
  static const int kCounts[] = {1, 2, 3, 4, 6, 8, 12, 16};
  for (int c : kCounts)
    if (need <= c) return c;
  return 0;
}

template <typename T>
cudaError_t launch_ring_any(const Args& a) {
  switch (packs_per_lane(a.dim / Pack16<T>::V)) {
    case 1: return launch_ring<T, 1>(a);
    case 2: return launch_ring<T, 2>(a);
    case 3: return launch_ring<T, 3>(a);
    case 4: return launch_ring<T, 4>(a);
    case 6: return launch_ring<T, 6>(a);
    case 8: return launch_ring<T, 8>(a);
    case 12: return launch_ring<T, 12>(a);
    case 16: return launch_ring<T, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Rows of whole 16-byte packs, every pointer 16-byte aligned.
template <typename T>
bool in_packs(const Args& a) {
  return a.dim % Pack16<T>::V == 0 && aligned16(a.x) && aligned16(a.out) &&
         aligned16(a.gamma) && aligned16(a.beta);
}

// The route the launcher takes for these pointers and shape.
template <typename T>
int pick_route(const Args& a) {
  const bool held = a.dim / Pack16<T>::V <= 32 * kMaxPacksPerLane;
  return in_packs<T>(a) && held ? kRing : kGeneric;
}

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr int V = Pack16<T>::V;
  if (pick_route<T>(a) == kRing) return launch_ring_any<T>(a);
  const int64_t blocks = (a.rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(a.x);
  T* op = static_cast<T*>(a.out);
  if (in_packs<T>(a)) {
    layernorm_fwd_kernel_generic<T, V>
        <<<static_cast<int>(blocks), kThreads, 0, a.stream>>>(
            xp, a.gamma, a.beta, op, a.rows, a.dim, a.eps);
  } else {
    layernorm_fwd_kernel_generic<T, 1>
        <<<static_cast<int>(blocks), kThreads, 0, a.stream>>>(
            xp, a.gamma, a.beta, op, a.rows, a.dim, a.eps);
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
  const Args a{x, gamma, beta, out, rows, dim, eps,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(a));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The route layernorm_fwd_launch takes for these pointers and `dim`
// (1 ring, 2 generic), or -1 for an unknown dtype.
extern "C" int layernorm_fwd_route(const void* x, const float* gamma,
                                   const float* beta, const void* out,
                                   int dim, int dtype) {
  const Args a{x, gamma, beta, const_cast<void*>(out), 1, dim, 0.f, nullptr};
  switch (dtype) {
    case 0: return pick_route<float>(a);
    case 1: return pick_route<__nv_bfloat16>(a);
    default: return -1;
  }
}

extern "C" const char* layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
