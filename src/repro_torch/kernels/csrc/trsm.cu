// Right-side upper-triangular solve for Hopper (sm_90a):  X[z] . U[z] = B[z].
//
// Replaces `repro/kernels/trsm.py:trsm_pallas` (body `_trsm_kernel`): the
// supernodal LU's panel solve L(I,K) = A(I,K) . U(K,K)^-1, one launch per
// supernode for all of struct(K) stacked along the rows.  B and X are
// contiguous (Z, m, k) stacks; U is a contiguous (k, k) upper triangle shared
// by every z (batch stride 0) or one per z; its strict lower triangle is not
// read.
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
// serial path's solves are small (k <= 96, a few hundred to a few thousand
// rows), so there the dependent chain along the columns sets the time.
//
// Design.  Rows of B are independent; column j of a row needs columns < j of
// the same row.  One warp owns RPW rows and walks the columns in panels of 32:
// lane c holds column p0 + c of each of its rows in registers.  The chain is
// kept short:
//  * No division in it.  With D = diag(U) and r = 1/D, the panel's own
//    triangle is solved against the unit triangle r_j u_jl (l > j; 0 on and
//    below the diagonal, by a select off the chain), so each of the 32
//    column steps is one warp shuffle of y_j and one FMA, the same FMA in
//    every lane (a zero multiplier leaves a lane unchanged): no branch.
//    x = y r after the panel.  The reciprocals are computed once per block,
//    in parallel, from the staged diagonal.  Rounding moves from x = t / u
//    to x = t * (1/u), within an ulp a step.
//  * Columns of earlier panels subtract x_i u_il, i < p0: x_i broadcast from
//    shared memory as 16-byte vectors, u_il from the staged panel.
//  * Staging by cp.async (f32, f64; element copies, zero-filled past k),
//    all of a stage's copies in flight at once, a warp copying 32 columns of
//    a row at a time (no division per element); bf16 through registers, 8
//    loads in flight a thread.  The block's rows of B are staged with the
//    first stage of U, into the shared x area that each x then overwrites,
//    so no panel waits on a load from device memory.
//    "resident": every panel of U staged once per block (the serial path's
//    k <= 96 in f64: 48 KB); "streamed": one panel at a time, where the
//    whole triangle does not fit a block (k = 256 in f64).
// Rows per block (4 per warp; 4 warps, one per scheduler, while the grid
// cannot fill half the 132 SMs, else 8) come from `trsm.plan`, which also
// passes the variant and the shared memory; the entry checks the latter
// against its own count.  Each output is
// produced by one lane, in an order that depends on neither the plan nor the
// other rows: a stacked launch gives the bits of per-block launches.  The
// shared-memory limit is raised once per kernel instance and device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RPW = 4;                 // rows per warp
constexpr int PW = 32;                 // panel width: one column per lane
constexpr int MAX_WARPS = 8;
constexpr int SMEM_LIMIT = 232448;     // 227 KB, the H100's per-block limit

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// c - a * b with one rounding; a * b rounded, never contracted
__device__ __forceinline__ float msub(float a, float b, float c) { return __fmaf_rn(-a, b, c); }
__device__ __forceinline__ double msub(double a, double b, double c) { return __fma_rn(-a, b, c); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }

// A rows x width tile (width a multiple of 32) into shared memory in the
// compute type: dst[i * width + c] = src[i * k + c], zero where i >= rlim
// or c >= clim.  A warp takes 32 consecutive columns of a row at a time, so
// the index math is one division per 32 elements, none for a 32-wide panel;
// cp.async element copies when the types agree, else loads through
// registers, a batch of them in flight before their stores.
template <typename T, typename Acc>
__device__ __forceinline__ void stage(Acc* dst, const T* src, int rows, int width,
                                      int rlim, int clim, int k, int warp, int lane,
                                      int nwarps) {
  constexpr int BATCH = 8;
  const int nch = width / 32;
  const int n = rows * nch;
  for (int q0 = warp; q0 < n; q0 += BATCH * nwarps) {
    Acc v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int q = q0 + b * nwarps;
      const int i = q / nch, c = (q - i * nch) * 32 + lane;
      const bool ok = q < n && i < rlim && c < clim;
      const T* p = src + (ok ? (long long)i * k + c : 0);
      if constexpr (sizeof(T) == sizeof(Acc)) {
        if (q < n) {
          const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i * width + c));
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                       "l"(p), "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0));
        }
      } else {
        v[b] = ok ? to_acc(*p) : Acc(0);
      }
    }
    if constexpr (sizeof(T) != sizeof(Acc)) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int q = q0 + b * nwarps;
        const int i = q / nch;
        if (q < n) dst[i * width + (q - i * nch) * 32 + lane] = v[b];
      }
    }
  }
}

// Elements of panel P (rows 0 .. 32P+31, its 32 columns) before panel P.
__host__ __device__ constexpr long long panel_off(int P) {
  return 512LL * P * (P + 1);
}

__host__ __device__ inline size_t smem_bytes(int kpad, int group, int rows,
                                             size_t acc) {
  const int np = kpad / PW;
  const long long us = group >= np ? panel_off(np) : (long long)kpad * PW;
  return ((size_t)kpad + (size_t)us + (size_t)rows * kpad) * acc;
}

template <typename Acc>
struct alignas(16) XVec {
  Acc v[16 / sizeof(Acc)];
};

template <typename T, typename Acc>
__global__ void __launch_bounds__(MAX_WARPS * 32)
trsm_kernel(const T* __restrict__ B, const T* __restrict__ U, T* __restrict__ X,
            int m, int k, int kpad, int group, long long sb, long long su) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x;
  const int rows = (nt / 32) * RPW;
  const int np = kpad / PW;
  const bool resident = group >= np;
  Acc* rs = reinterpret_cast<Acc*>(smem_raw);             // [kpad] 1/u_ii
  Acc* Us = rs + kpad;                                    // staged panels
  Acc* xs = Us + (resident ? panel_off(np) : (long long)kpad * PW);  // [rows][kpad]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long z = blockIdx.y;
  const T* Bz = B + z * sb;
  const T* Uz = U + z * su;
  T* Xz = X + z * sb;
  const int row0 = blockIdx.x * rows + warp * RPW;
  Acc* xw = xs + (size_t)warp * RPW * kpad;

  // the block's rows of B, into the x area (each x overwrites its b)
  stage<T, Acc>(xs, Bz + (long long)blockIdx.x * rows * k, rows, kpad,
                m - blockIdx.x * rows, k, k, warp, lane, nt / 32);

  for (int g0 = 0; g0 < np; g0 += group) {
    const int g1 = min(np, g0 + group);
    const long long base = panel_off(g0);
    if (g0) __syncthreads();                  // the previous stage is read
    // the stage's panels, raw: rows 0 .. 32P+31 of columns 32P .. 32P+31
    for (int P = g0; P < g1; ++P)
      stage<T, Acc>(Us + (panel_off(P) - base), Uz + P * PW, (P + 1) * PW, PW,
                    k, k - P * PW, k, warp, lane, nt / 32);
    if constexpr (sizeof(T) == sizeof(Acc)) asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // the reciprocals of the stage's diagonal, from the staged panels
    for (int c = g0 * PW + tid; c < g1 * PW; c += nt)
      rs[c] = c < k ? rcp(Us[(panel_off(c / PW) - base) + (long long)c * PW + c % PW])
                    : Acc(0);
    __syncthreads();

    for (int P = g0; P < g1; ++P) {
      const int p0 = P * PW;
      const Acc* Up = Us + (panel_off(P) - base);
      Acc acc[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) acc[rr] = xw[rr * kpad + p0 + lane];
      // columns of the earlier panels, x_i broadcast in vectors of XV
      constexpr int XV = 16 / sizeof(Acc);
#pragma unroll 2
      for (int i = 0; i < p0; i += XV) {
        XVec<Acc> xv[RPW];
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          xv[rr] = *reinterpret_cast<const XVec<Acc>*>(xw + rr * kpad + i);
#pragma unroll
        for (int e = 0; e < XV; ++e) {
          const Acc u = Up[(i + e) * PW + lane];
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) acc[rr] = msub(xv[rr].v[e], u, acc[rr]);
        }
      }
      // the panel's unit triangle r_j u_jl, l > j (0 on and below the
      // diagonal, a select off the chain): shuffle y_j, one FMA in every lane
      const Acc* tri = Up + (long long)p0 * PW;
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        const Acc u = lane > j ? mul(tri[j * PW + lane], rs[p0 + j]) : Acc(0);
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          acc[rr] = msub(__shfl_sync(0xffffffffu, acc[rr], j), u, acc[rr]);
      }
      const Acc rc = rs[p0 + lane];
      const int col = p0 + lane;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = row0 + rr;
        const Acc x = mul(acc[rr], rc);
        xw[rr * kpad + col] = x;
        if (r < m && col < k) store(Xz + (long long)r * k + col, x);
      }
      __syncwarp();
    }
  }
}

template <typename T, typename Acc>
int launch(const void* B, const void* U, void* X, int m, int k, int Z,
           long long su, int warps, int group, long long smem,
           cudaStream_t stream) {
  const int kpad = (k + PW - 1) / PW * PW;
  if (warps < 1 || warps > MAX_WARPS || (group != 1 && group < kpad / PW) ||
      smem != (long long)smem_bytes(kpad, group, warps * RPW, sizeof(Acc)) ||
      smem > SMEM_LIMIT)
    return 1001;                               // not a plan of trsm.plan
  auto kern = trsm_kernel<T, Acc>;
  static unsigned raised = 0;                  // one bit per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(raised & (1u << dev))) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised |= 1u << dev;
  }
  const int rows = warps * RPW;
  dim3 grid((m + rows - 1) / rows, Z);
  kern<<<grid, warps * 32, smem, stream>>>(static_cast<const T*>(B),
                                           static_cast<const T*>(U),
                                           static_cast<T*>(X), m, k, kpad,
                                           group, (long long)m * k, su);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  B, X: contiguous (Z, m, k);
// U: contiguous (k, k) per z at batch stride su (0 = one U for every z), in
// elements.  warps (of 4 rows each), group (panels per stage: all of them =
// resident, 1 = streamed) and smem (bytes) as `trsm.plan` gives them.
// Returns the cudaError_t of the launch (0 on success); 1000 for an unknown
// dtype, 1001 for a plan the kernel does not take.
extern "C" int trsm_launch(int dtype, const void* B, const void* U, void* X,
                           int m, int k, int Z, long long su, int warps,
                           int group, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float>(B, U, X, m, k, Z, su, warps, group, smem, s);
    case 1: return launch<__nv_bfloat16, float>(B, U, X, m, k, Z, su, warps, group, smem, s);
    case 2: return launch<double, double>(B, U, X, m, k, Z, su, warps, group, smem, s);
    default: return 1000;
  }
}
