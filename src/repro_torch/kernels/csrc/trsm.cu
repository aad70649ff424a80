// Right-side upper-triangular solve for Hopper (sm_90a):  X[z] . U[z] = B[z].
//
// Replaces `repro/kernels/trsm.py:trsm_pallas` (body `_trsm_kernel`): the
// supernodal LU's panel solve L(I,K) = A(I,K) . U(K,K)^-1, one call per block
// of struct(K).  B and X are contiguous (Z, m, k) stacks; U is a contiguous
// (k, k) upper triangle shared by every z (batch stride 0) or one per z.
//
// Types.  f32 in / f32 compute / f32 out; bf16 in / f32 compute / bf16 out;
// f64 in / f64 compute / f64 out.  The TPU kernel computes in f32 even for
// f64 input; this one keeps f64, because the serial path's contract is 1e-12.
//
// What bounds it.  Each row of B needs k^2/2 multiply-adds (k^2 operations)
// against 2k elements moved (B read once, X written once; U once more per
// call): k/16 operations per byte in f64, k/8 in f32, k/4 in bf16.  Against
// H100 SXM peaks (3.35 TB/s; 67 TFLOP/s f64 and f32, 989 bf16) the ridge sits
// at 20 operations per byte for f64/f32 and 295 for bf16, so f64 and bf16 are
// bound by bytes up to k = 256, and f32 by operations above k = 160.  The
// serial path's calls are tiny (m = k = 96 in f64: 0.22 MB, 66 ns at the
// memory rate), so there the launch and the dependent chain of k divisions
// set the time, not either bound.
//
// Design.  Rows of B are independent; column j of a row needs columns < j of
// the same row.  So one warp owns RPW rows and walks the columns in panels of
// 32: lane c holds column p0 + c of each of its rows in registers.  For each
// panel the block stages the column panel U[0 : p0+32, p0 : p0+32] in shared
// memory (so k = 256 in f64 -- 512 KB of U, more than a block can hold -- is
// streamed panel by panel, and any k <= 256 takes the same path), every lane
// subtracts the finished columns i < p0 (its row's x_i broadcast from shared
// memory, U[i][p0+c] from the panel: one conflict-free load feeds RPW
// multiply-adds), and then the 32 columns of the panel are solved in order,
// x_j passed from lane j to the others by a warp shuffle.  The finished panel
// goes to X and to the rows' shared copy for the panels after it.  The TPU's
// 128-row tile loop has no counterpart: blocks of 32 rows run in parallel.
// Shared memory is (32 + 32) * kpad elements of the compute type (128 KB at
// k = 256 in f64), above the 48 KB static limit, so it is dynamic and the
// launch raises the kernel's limit with cudaFuncSetAttribute first.  Each
// output is produced by one lane in a fixed order: no atomics, reproducible.
// Left to later work: more rows per block for a better reuse of each U panel,
// and batching the serial path's many small solves into one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int RPW = 4;                 // rows per warp
constexpr int ROWS = WARPS * RPW;      // rows per block
constexpr int NT = WARPS * 32;
constexpr int PW = 32;                 // panel width: one column per lane

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// c - a * b with one rounding
__device__ __forceinline__ float msub(float a, float b, float c) { return __fmaf_rn(-a, b, c); }
__device__ __forceinline__ double msub(double a, double b, double c) { return __fma_rn(-a, b, c); }

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
trsm_kernel(const T* __restrict__ B, const T* __restrict__ U, T* __restrict__ X,
            int m, int k, int kpad, long long sb, long long su) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* Us = reinterpret_cast<Acc*>(smem_raw);          // [kpad][PW] column panel
  Acc* xs = Us + (size_t)kpad * PW;                    // [ROWS][kpad] solved x

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long z = blockIdx.y;
  const T* Bz = B + z * sb;
  const T* Uz = U + z * su;
  T* Xz = X + z * sb;
  const int row0 = blockIdx.x * ROWS + warp * RPW;
  Acc* xw = xs + (size_t)warp * RPW * kpad;

  for (int p0 = 0; p0 < k; p0 += PW) {
    const int pw = min(PW, k - p0);
    const int col = p0 + lane;
    __syncthreads();                        // the previous panel is read
    for (int idx = tid; idx < (p0 + pw) * PW; idx += NT) {
      const int i = idx / PW, c = idx % PW;
      Us[idx] = (p0 + c < k) ? to_acc(Uz[(long long)i * k + p0 + c]) : Acc(0);
    }
    __syncthreads();

    Acc acc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = row0 + rr;
      acc[rr] = (r < m && col < k) ? to_acc(Bz[(long long)r * k + col]) : Acc(0);
    }
    // columns of the earlier panels
    for (int i = 0; i < p0; ++i) {
      const Acc u = Us[i * PW + lane];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) acc[rr] = msub(xw[rr * kpad + i], u, acc[rr]);
    }
    // the panel's own triangle, column by column
    for (int j = 0; j < pw; ++j) {
      const Acc* urow = Us + (p0 + j) * PW;
      const Acc ujj = urow[j];
      const Acc uj = urow[lane];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const Acc xj = __shfl_sync(0xffffffffu, acc[rr], j) / ujj;
        if (lane == j) acc[rr] = xj;
        else if (lane > j) acc[rr] = msub(xj, uj, acc[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = row0 + rr;
      xw[rr * kpad + col] = acc[rr];
      if (r < m && col < k) store(Xz + (long long)r * k + col, acc[rr]);
    }
    __syncwarp();
  }
}

template <typename T, typename Acc>
int launch(const void* B, const void* U, void* X, int m, int k, int Z,
           long long su, cudaStream_t stream) {
  const int kpad = (k + PW - 1) / PW * PW;
  const size_t smem = ((size_t)kpad * PW + (size_t)ROWS * kpad) * sizeof(Acc);
  auto kern = trsm_kernel<T, Acc>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((m + ROWS - 1) / ROWS, Z);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(B),
                                   static_cast<const T*>(U),
                                   static_cast<T*>(X), m, k, kpad,
                                   (long long)m * k, su);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  B, X: contiguous (Z, m, k);
// U: contiguous (k, k) per z at batch stride su (0 = one U for every z), in
// elements.  Returns the cudaError_t of the launch (0 on success); 1000 for an
// unknown dtype.
extern "C" int trsm_launch(int dtype, const void* B, const void* U, void* X,
                           int m, int k, int Z, long long su, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float>(B, U, X, m, k, Z, su, s);
    case 1: return launch<__nv_bfloat16, float>(B, U, X, m, k, Z, su, s);
    case 2: return launch<double, double>(B, U, X, m, k, Z, su, s);
    default: return 1000;
  }
}
