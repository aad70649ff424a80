// RMSNorm over the last axis for Hopper (sm_90a):
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale
//
// Replaces `repro/kernels/rmsnorm.py:rmsnorm_pallas` (body `_rmsnorm_kernel`).
// As there: statistics in f32, the scale applied in the same pass, all in
// f32, one rounding to x's type at the store.  x and out are contiguous
// (rows, d) in f32 or bf16; scale is (d,) in f32 (the wrapper converts it).
//
// What bounds it.  About 4 operations per element against 2 elements moved
// (x read once, out written once): memory-bound in every type; the least
// time is 2 * rows * d * sizeof(T) / 3.35 TB/s on an H100 SXM.
//
// Design.  The TPU kernel keeps a 256-row tile whole in VMEM.  Here a row
// group of threads owns one row: one warp per row for d <= 1024 (eight rows
// per block of 256 threads), the whole block per row above that.  Loads and
// stores are 16 bytes a thread (4 f32 or 8 bf16) when d and the pointers
// allow it, else one element; consecutive threads touch consecutive vectors,
// so the reads coalesce.  The sum of squares is reduced by warp shuffles (and
// across the block's warps through shared memory, every thread adding the
// eight partials in the same order), then the row is read a second time --
// from L1/L2, at most 64 KB a row -- scaled and stored.  One rounding, no
// atomics.  Left to later work: keeping the row in registers for one read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& y, float v) { y = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& y, float v) { y = __float2bfloat16(v); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V, bool WARP_ROW>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  const int tid = threadIdx.x;
  const int g = WARP_ROW ? 32 : NT;              // threads per row
  const int gid = WARP_ROW ? (tid & 31) : tid;
  const long long row = WARP_ROW ? (long long)blockIdx.x * (NT / 32) + (tid >> 5)
                                 : (long long)blockIdx.x;
  // whole warps leave together: the block-wide reduction runs only when
  // one block owns one row, and then every thread stays
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int c = gid * V; c < d; c += g * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f(p.v[i]);
      ss = __fmaf_rn(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (!WARP_ROW) {
    __shared__ float part[NT / 32];
    if ((tid & 31) == 0) part[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) ss += part[w];
  }
  const float r = 1.0f / sqrtf(ss / (float)d + eps);

  for (int c = gid * V; c < d; c += g * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + c);
    Pack<T, V> q;
#pragma unroll
    for (int i = 0; i < V; ++i) from_f(q.v[i], to_f(p.v[i]) * r * scale[c + i]);
    *reinterpret_cast<Pack<T, V>*>(orow + c) = q;
  }
}

template <typename T, int V>
void launch(const void* x, const float* scale, void* out, long long rows,
            int d, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (d <= 1024) {
    const long long blocks = (rows + NT / 32 - 1) / (NT / 32);
    rmsnorm_kernel<T, V, true><<<(unsigned)blocks, NT, 0, stream>>>(
        xp, scale, op, rows, d, eps);
  } else {
    rmsnorm_kernel<T, V, false><<<(unsigned)rows, NT, 0, stream>>>(
        xp, scale, op, rows, d, eps);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 for element loads, else 16-byte
// loads (d a multiple of 16 / sizeof(T), x and out 16-byte aligned).
// Returns the cudaError_t of the launch (0 on success); 1000 for an unknown
// dtype.
extern "C" int rmsnorm_launch(int dtype, int vec, const void* x,
                              const float* scale, void* out, long long rows,
                              int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (vec) launch<float, 4>(x, scale, out, rows, d, eps, s);
      else launch<float, 1>(x, scale, out, rows, d, eps, s);
      break;
    case 1:
      if (vec) launch<__nv_bfloat16, 8>(x, scale, out, rows, d, eps, s);
      else launch<__nv_bfloat16, 1>(x, scale, out, rows, d, eps, s);
      break;
    default: return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}
