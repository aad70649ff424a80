// RMSNorm over the last axis for Hopper (sm_90a):
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
//
// Replaces `repro/kernels/rmsnorm.py:rmsnorm_pallas` (body `_rmsnorm_kernel`).
// As there: statistics in f32, the scale applied in the same pass, all in
// f32, one rounding to x's type at the store.  x and out are contiguous
// (rows, d) in f32 or bf16; scale is (d,) in f32 or bf16, read in its own
// type (no conversion kernel before the launch).
//
// What bounds it.  About 4 operations per element against 2 elements moved
// (x read once, out written once): memory-bound in every type; the least
// time is 2 * rows * d * sizeof(T) / 3.35 TB/s on an H100 SXM.
//
// Design.  The TPU kernel keeps a 256-row tile whole in VMEM and reads it
// once.  Here a group of G threads owns one row, and each thread keeps its
// PPT packs of the row in registers from the sum of squares to the scaled
// store: x is read from device memory once.  A pack is 16 bytes (8 bf16 or
// 4 f32) when d and the pointers allow it, else one element; pack q of a
// thread is pack gid + q * G of the row, so a warp's loads are consecutive.
// `rmsnorm.plan` picks G and PPT so that G * PPT packs cover the row with no
// idle pass (320 threads x 2 packs at d = 5120 bf16; 16 threads x 1 pack at
// d = 128 bf16, two rows a warp): G <= 32 is a power of two and a warp holds
// 32 / G rows, reduced by shuffles inside the group; G > 32 is the whole
// block, one row, reduced across its warps through shared memory (every
// thread adds the partials in the same order).  Rows wider than 512
// threads x 32 elements take the "two_pass" variant: a block of 256 threads
// loops over the row, sums, then reads it again (from L2) to scale and
// store.  The scale is read as packs of its own type.  One rounding, no
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 512;         // 128 registers a thread: no spills
constexpr int TWO_PASS_NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& y, float v) { y = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& y, float v) { y = __float2bfloat16(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V >= 16 ? 16 : sizeof(T) * V) Pack {
  T v[V];
};

// sum of a warp's lanes in groups of `width` lanes (a power of two <= 32)
__device__ __forceinline__ float group_sum(float s, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int V, typename S>
__device__ __forceinline__ void scale_store(const Pack<T, V>& p, const S* scale,
                                            T* orow, long long c, float r) {
  const Pack<S, V> s = *reinterpret_cast<const Pack<S, V>*>(scale + c);
  Pack<T, V> q;
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(q.v[i], to_f(p.v[i]) * r * to_f(s.v[i]));
  *reinterpret_cast<Pack<T, V>*>(orow + c) = q;
}

// one read: G threads a row, PPT packs of V elements each in registers
template <typename T, int V, int PPT, typename S>
__global__ void __launch_bounds__(MAX_NT)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, int G, float eps) {
  __shared__ float part[MAX_NT / 32];
  const int tid = threadIdx.x;
  const bool sub = G <= 32;                   // a warp holds 32 / G rows
  const int gid = sub ? (tid & (G - 1)) : tid;
  const long long row = sub ? (long long)blockIdx.x * (blockDim.x / G) + tid / G
                            : (long long)blockIdx.x;
  // lanes past the last row stay for the shuffles, and load nothing
  const bool live = row < rows;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  Pack<T, V> p[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const long long c = (long long)(gid + q * G) * V;
    if (live && c < d) {
      p[q] = *reinterpret_cast<const Pack<T, V>*>(xr + c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) from_f(p[q].v[i], 0.f);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < PPT; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f(p[q].v[i]);
      ss = __fmaf_rn(f, f, ss);
    }
  if (sub) {
    ss = group_sum(ss, G);
  } else {
    ss = group_sum(ss, 32);
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < G / 32; ++w) ss += part[w];
  }
  const float r = 1.0f / sqrtf(ss / (float)d + eps);
  if (!live) return;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const long long c = (long long)(gid + q * G) * V;
    if (c < d) scale_store<T, V, S>(p[q], scale, orow, c, r);
  }
}

// two passes: a block of TWO_PASS_NT threads a row, any d
template <typename T, int V, typename S>
__global__ void __launch_bounds__(TWO_PASS_NT)
rmsnorm_two_pass(const T* __restrict__ x, const S* __restrict__ scale,
                 T* __restrict__ out, long long rows, int d, float eps) {
  __shared__ float part[TWO_PASS_NT / 32];
  const int tid = threadIdx.x;
  const T* xr = x + (long long)blockIdx.x * d;
  T* orow = out + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (long long c = (long long)tid * V; c < d; c += TWO_PASS_NT * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f(p.v[i]);
      ss = __fmaf_rn(f, f, ss);
    }
  }
  ss = group_sum(ss, 32);
  if ((tid & 31) == 0) part[tid >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < TWO_PASS_NT / 32; ++w) ss += part[w];
  const float r = 1.0f / sqrtf(ss / (float)d + eps);
  for (long long c = (long long)tid * V; c < d; c += TWO_PASS_NT * V)
    scale_store<T, V, S>(*reinterpret_cast<const Pack<T, V>*>(xr + c), scale,
                         orow, c, r);
}

template <typename T, int V, typename S>
int launch(int ppt, int G, int threads, const void* x, const void* scale,
           void* out, long long rows, int d, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (ppt == 0) {                              // the two-pass variant
    if (threads != TWO_PASS_NT) return 1001;
    rmsnorm_two_pass<T, V, S><<<(unsigned)rows, TWO_PASS_NT, 0, stream>>>(
        xp, sp, op, rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  // G <= 32: a power of two, 32 / G rows a warp; else the block, a row
  const bool sub = G <= 32;
  if (G < 1 || threads < 32 || threads > MAX_NT || threads % 32 ||
      (sub ? (G & (G - 1)) != 0 : G != threads))
    return 1001;
  const long long per = sub ? threads / G : 1;
  const long long blocks = (rows + per - 1) / per;
  switch (ppt) {
#define RMS_CASE(N)                                                         \
  case N:                                                                   \
    if constexpr (N * V <= 32)                                              \
      rmsnorm_kernel<T, V, N, S><<<(unsigned)blocks, threads, 0, stream>>>( \
          xp, sp, op, rows, d, G, eps);                                     \
    else                                                                    \
      return 1001;                                                          \
    break;
    RMS_CASE(1) RMS_CASE(2) RMS_CASE(4) RMS_CASE(8)
#undef RMS_CASE
    default: return 1001;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_v(int vec, int ppt, int G, int threads, const void* x,
             const void* scale, void* out, long long rows, int d, float eps,
             cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  return vec ? launch<T, VEC, S>(ppt, G, threads, x, scale, out, rows, d, eps, s)
             : launch<T, 1, S>(ppt, G, threads, x, scale, out, rows, d, eps, s);
}

}  // namespace

// dtype, stype: 0 = float32, 1 = bfloat16 (x and out; scale).  vec: 1 for
// 16-byte packs (d a multiple of 16 / sizeof(x), x, out and scale 16-byte
// aligned), else single elements.  ppt (packs a thread, 0 = the two-pass
// variant), G (threads a row) and threads (a block) as `rmsnorm.plan`
// gives them.  Returns the cudaError_t of the launch (0 on success); 1000
// for an unknown type, 1001 for a plan the kernel does not take.
extern "C" int rmsnorm_launch(int dtype, int stype, int vec, int ppt, int G,
                              int threads, const void* x, const void* scale,
                              void* out, long long rows, int d, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype < 0 || dtype > 1 || stype < 0 || stype > 1) return 1000;
  switch (dtype * 2 + stype) {
    case 0: return launch_v<float, float>(vec, ppt, G, threads, x, scale, out, rows, d, eps, s);
    case 1: return launch_v<float, __nv_bfloat16>(vec, ppt, G, threads, x, scale, out, rows, d, eps, s);
    case 2: return launch_v<__nv_bfloat16, float>(vec, ppt, G, threads, x, scale, out, rows, d, eps, s);
    case 3: return launch_v<__nv_bfloat16, __nv_bfloat16>(vec, ppt, G, threads, x, scale, out, rows, d, eps, s);
    default: return 1000;
  }
}
