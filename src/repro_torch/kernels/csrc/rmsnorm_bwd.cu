// RMSNorm backward for Hopper (sm_90a): the gradient of `rmsnorm.cu`,
//     y = x * r * s,  r = rsqrt(mean(x^2) + eps)   (each row, in f32)
//     dx = r * (dy o s) - x * r^3 * mean(dy o s o x)   rounded once to x's type
//     ds = sum over rows of dy o x * r                 in f32
//
// The TPU kernel `repro/kernels/rmsnorm.py:rmsnorm_pallas` has no backward
// (the JAX package differentiates its jnp RMSNorm); this one is the gradient
// of the port's own kernel, whose one f32 rounding it keeps: r, the row sums
// and the products are f32, and dx is rounded once at the store.
//
// What bounds it.  About 10 operations per element against x and dy read
// and dx written once: memory-bound in every type; the least time is
// 3 * rows * d * sizeof(T) / 3.35 TB/s on an H100 SXM.
//
// Design.  As the forward: a group of G threads owns a row and keeps its
// PPT packs of x and dy in registers from the two row sums to the store
// (a 16-byte pack, or one element), so each is read once.  G <= 32 is a
// power of two (a warp holds 32 / G rows, reduced by shuffles in the
// group); otherwise G is the block of 256 threads and one row is reduced
// across its warps through shared memory in a fixed order.  A block takes
// `rpb` consecutive rows (`rmsnorm_bwd.plan` sizes the grid to about four
// blocks an SM) and every group of it walks them in the same number of
// steps, so all lanes meet at every shuffle and barrier.  ds: each thread
// sums dy * x * r over its rows for its own columns in registers; the
// block adds its groups' sums in group order into one partial row
// (`partial[block][d]`), and a second kernel adds the partial rows in block
// order.  No atomics: ds and dx are bitwise reproducible.

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
struct alignas(sizeof(T) * V >= 16 ? 16 : sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float group_sum(float s, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int V, int PPT, typename S>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int d, int G,
                   long long rpb, float eps) {
  extern __shared__ float colsum[];          // [NT / G][d] (1 row when G = NT)
  __shared__ float red[2][NT / 32];
  const int tid = threadIdx.x;
  const bool sub = G <= 32;
  const int gid = sub ? (tid & (G - 1)) : tid;
  const int per = sub ? NT / G : 1;          // rows a block step
  const int rs = sub ? tid / G : 0;

  float sv[PPT][V], dsa[PPT][V];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const long long c = (long long)(gid + q * G) * V;
    if (c < d) {
      const Pack<S, V> p = *reinterpret_cast<const Pack<S, V>*>(scale + c);
#pragma unroll
      for (int i = 0; i < V; ++i) sv[q][i] = to_f(p.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) sv[q][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dsa[q][i] = 0.f;
  }

  const long long row0 = (long long)blockIdx.x * rpb;
  const long long row1 = min(rows, row0 + rpb);
  const long long steps = (rpb + per - 1) / per;
  for (long long it = 0; it < steps; ++it) {
    const long long row = row0 + it * per + rs;
    const bool live = row < row1;
    Pack<T, V> px[PPT], pg[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const long long c = (long long)(gid + q * G) * V;
      if (live && c < d) {
        px[q] = *reinterpret_cast<const Pack<T, V>*>(x + row * d + c);
        pg[q] = *reinterpret_cast<const Pack<T, V>*>(dy + row * d + c);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          from_f(px[q].v[i], 0.f);
          from_f(pg[q].v[i], 0.f);
        }
      }
    }
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int q = 0; q < PPT; ++q)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = to_f(px[q].v[i]);
        ss = __fmaf_rn(xv, xv, ss);
        sd = __fmaf_rn(to_f(pg[q].v[i]) * sv[q][i], xv, sd);
      }
    if (sub) {
      ss = group_sum(ss, G);
      sd = group_sum(sd, G);
    } else {
      ss = group_sum(ss, 32);
      sd = group_sum(sd, 32);
      if ((tid & 31) == 0) {
        red[0][tid >> 5] = ss;
        red[1][tid >> 5] = sd;
      }
      __syncthreads();
      ss = sd = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        ss += red[0][w];
        sd += red[1][w];
      }
      __syncthreads();                       // red is read before the next row
    }
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float c3 = sd / (float)d * r * r * r;
    if (!live) continue;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const long long c = (long long)(gid + q * G) * V;
      if (c >= d) continue;
      Pack<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = to_f(px[q].v[i]), gv = to_f(pg[q].v[i]);
        from_f(o.v[i], r * (gv * sv[q][i]) - xv * c3);
        dsa[q][i] = __fmaf_rn(gv * xv, r, dsa[q][i]);
      }
      *reinterpret_cast<Pack<T, V>*>(dx + row * d + c) = o;
    }
  }

  // the block's partial row: its groups' column sums added in group order
#pragma unroll
  for (int q = 0; q < PPT; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long c = (long long)(gid + q * G) * V + i;
      if (c < d) colsum[rs * d + c] = dsa[q][i];
    }
  __syncthreads();
  for (int c = tid; c < d; c += NT) {
    float a = 0.f;
    for (int u = 0; u < per; ++u) a += colsum[u * d + c];
    partial[(long long)blockIdx.x * d + c] = a;
  }
}

// ds[c] = sum over blocks, in block order, of partial[block][c]
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_ds(const float* __restrict__ partial, float* __restrict__ ds,
               int blocks, int d) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= d) return;
  float a = 0.f;
  for (int b = 0; b < blocks; ++b) a += partial[(long long)b * d + c];
  ds[c] = a;
}

template <typename T, int V, typename S>
int launch(int ppt, int G, long long rpb, int blocks, const void* x,
           const void* scale, const void* dy, void* dx, float* partial,
           float* ds, long long rows, int d, float eps, cudaStream_t stream) {
  const bool sub = G <= 32;
  if (G < 1 || (sub ? (G & (G - 1)) != 0 : G != NT) || rpb < 1 || blocks < 1)
    return 1001;
  const size_t smem = sizeof(float) * (size_t)(sub ? NT / G : 1) * d;
  if (smem > 48 * 1024) return 1001;
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  switch (ppt) {
#define RMSB_CASE(N)                                                           \
  case N:                                                                      \
    if constexpr (N * V <= 32)                                                 \
      rmsnorm_bwd_kernel<T, V, N, S><<<(unsigned)blocks, NT, smem, stream>>>(  \
          xp, sp, gp, op, partial, rows, d, G, rpb, eps);                      \
    else                                                                       \
      return 1001;                                                             \
    break;
    RMSB_CASE(1) RMSB_CASE(2) RMSB_CASE(4) RMSB_CASE(8)
#undef RMSB_CASE
    default: return 1001;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rmsnorm_bwd_ds<<<(d + NT - 1) / NT, NT, 0, stream>>>(partial, ds, blocks, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_v(int vec, int ppt, int G, long long rpb, int blocks, const void* x,
             const void* scale, const void* dy, void* dx, float* partial,
             float* ds, long long rows, int d, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  return vec ? launch<T, VEC, S>(ppt, G, rpb, blocks, x, scale, dy, dx, partial, ds, rows, d, eps, s)
             : launch<T, 1, S>(ppt, G, rpb, blocks, x, scale, dy, dx, partial, ds, rows, d, eps, s);
}

}  // namespace

// dtype, stype: 0 = float32, 1 = bfloat16 (x, dy and dx; scale).  vec, ppt
// and G as `rmsnorm_bwd.plan` gives them (16-byte packs; packs a thread; a
// power of two <= 32, or 256 for a row a block); rpb rows a block and
// `blocks` blocks.  partial: (blocks, d) f32 scratch; ds: (d,) f32 out.
// Returns the cudaError_t of the launches (0 on success); 1000 for an
// unknown type, 1001 for a plan the kernel does not take.
extern "C" int rmsnorm_bwd_launch(int dtype, int stype, int vec, int ppt,
                                  int G, long long rpb, int blocks,
                                  const void* x, const void* scale,
                                  const void* dy, void* dx, void* partial,
                                  void* ds, long long rows, int d, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* dp = static_cast<float*>(ds);
  switch (dtype * 2 + stype) {
    case 0: return launch_v<float, float>(vec, ppt, G, rpb, blocks, x, scale, dy, dx, pp, dp, rows, d, eps, s);
    case 1: return launch_v<float, __nv_bfloat16>(vec, ppt, G, rpb, blocks, x, scale, dy, dx, pp, dp, rows, d, eps, s);
    case 2: return launch_v<__nv_bfloat16, float>(vec, ppt, G, rpb, blocks, x, scale, dy, dx, pp, dp, rows, d, eps, s);
    case 3: return launch_v<__nv_bfloat16, __nv_bfloat16>(vec, ppt, G, rpb, blocks, x, scale, dy, dx, pp, dp, rows, d, eps, s);
    default: return 1000;
  }
}
