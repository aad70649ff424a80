// Batched block-strided GEMM for Hopper (sm_90a):  C[z] = alpha * A[z] @ B[z].
//
// Replaces `repro/kernels/block_gemm.py:block_gemm_pallas` (body `_gemm_kernel`),
// the one TPU kernel on the selected-inversion sweep's main path
// (`_phase_gemm` -> `pselinv_round_gemm` -> `pselinv_level_gemm`).  One launch
// covers every batch item z (blockIdx.z): on the main path z runs over the
// B matrices times the P virtual ranks of one `gemm` compute op, which is what
// the TPU kernel computed once per device.
//
// Layout.  Each operand is a logical 2-D matrix per z whose rows and columns
// are each split into blocks: element (r, c) lives at
//     z*sz + (r / rblk)*ro + (r % rblk)*ri + (c / cblk)*co + (c % cblk)*ci
// so the sweep's blocked tensors are read and written where they lie:
//     A = A^-1  (nbr, nbc, b, b)  as (nbr*b) x (nbc*b),
//     B = U^    (nk, nbc, b, b)   as (nbc*b) x (nk*b), transposed per block,
//     C = partial (nk, nbr, b, b) as (nbr*b) x (nk*b), written straight into
//         the sweep's arena.
// The JAX package reshapes and pads (`_pad_to`) instead; here no operand is
// copied, and ragged M/N/K edges (b = 96 is not a power of two) are masked in
// the loads and the store.  A plain row-major matrix is the case rblk = M,
// cblk = K (one block).
//
// Types.  f32 in / f32 accumulate / f32 out; bf16 in / f32 accumulate / bf16
// out; f64 in / f64 accumulate / f64 out.  The TPU kernel keeps an f32
// accumulator even for f64 input (`block_gemm.py:67`); this one accumulates f64
// in f64, because the engine's contract is f64 within 1e-12 of the dense
// oracle.  alpha is applied once, at the store, in the accumulate type.
//
// What bounds it.  At the main-path shapes of the FEM setting (P = 8 ranks,
// m = nbr*b = 3072, k = nbc*b = 6144, n = nk*96 with nk = 1..14) the work is
// 2*m*n*k flops against m*k reads of A^-1 per rank: n/4 flops per byte of
// A^-1 in f64, n/2 in f32, n in bf16.  Against H100 SXM peaks (3.35 TB/s;
// 67 TFLOP/s f64 on the tensor cores, 67 TFLOP/s f32 outside them, 989
// TFLOP/s bf16) the ridge sits near n = 80 in f64, n = 40 in f32 and
// n = 295 in bf16.  So the nk = 1 launches (n = 96) are just above the ridge
// in f64 -- reading A^-1 costs nearly as much as the arithmetic -- and in bf16
// every launch with nk <= 3 is bound by reading A^-1; the wide levels are
// bound by arithmetic in every type.
//
// Design.  A simple tiled kernel: a 64x64 output tile per block of 256
// threads, a 16-deep K slab staged in shared memory (the loop over K inside
// the block replaces the TPU's sequential K grid axis and its VMEM
// accumulator), a 4x4 register micro-tile per thread, FMA in the accumulate
// type.  The staging loads walk whichever index of the operand is contiguous,
// so global reads coalesce for both the blocked and the row-major layouts.
// Each output element is summed by one thread in a fixed K order (no split-K,
// no atomics), so the result is bitwise reproducible and does not depend on
// the batch size.  Against the A^-1 read, the design does little: each 64-wide
// N tile re-reads its A^-1 row panel (through L2), so a narrow level (n = 96:
// two N tiles, the second half empty) reads A^-1 twice.  Left to later work:
// wgmma / DMMA tensor-core products, TMA loads into a multi-stage
// shared-memory ring, and N tiles sized to the level so A^-1 is read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

struct Operand {
  long long sz;         // batch stride
  int rblk;             // rows per row block
  long long ro, ri;     // stride between row blocks, inside a row block
  int cblk;             // columns per column block
  long long co, ci;     // stride between column blocks, inside a column block
};

__device__ __forceinline__ long long row_off(const Operand& d, int r) {
  return (long long)(r / d.rblk) * d.ro + (long long)(r % d.rblk) * d.ri;
}

__device__ __forceinline__ long long col_off(const Operand& d, int c) {
  return (long long)(c / d.cblk) * d.co + (long long)(c % d.cblk) * d.ci;
}

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

__device__ __forceinline__ float mac(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double mac(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
block_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int M, int N, int K, Acc alpha,
                  Operand da, Operand db, Operand dc, int a_kfast,
                  int b_kfast) {
  __shared__ Acc As[BK][BM + 1];
  __shared__ Acc Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const T* Az = A + z * da.sz;
  const T* Bz = B + z * db.sz;

  // staging map: each thread loads four elements of each tile; the index
  // that runs over consecutive threads is the operand's contiguous one
  int am[4], ak[4], bk[4], bn[4];
  long long aoff[4], boff[4];
  bool aok[4], bok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (a_kfast) { ak[r] = tid % BK; am[r] = tid / BK + 16 * r; }
    else         { am[r] = tid % BM; ak[r] = tid / BM + 4 * r; }
    if (b_kfast) { bk[r] = tid % BK; bn[r] = tid / BK + 16 * r; }
    else         { bn[r] = tid % BN; bk[r] = tid / BN + 4 * r; }
    aok[r] = m0 + am[r] < M;
    bok[r] = n0 + bn[r] < N;
    aoff[r] = aok[r] ? row_off(da, m0 + am[r]) : 0;
    boff[r] = bok[r] ? col_off(db, n0 + bn[r]) : 0;
  }

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ka = k0 + ak[r];
      Acc va = Acc(0);
      if (aok[r] && ka < K) va = to_acc(Az[aoff[r] + col_off(da, ka)]);
      As[ak[r]][am[r]] = va;
      const int kb = k0 + bk[r];
      Acc vb = Acc(0);
      if (bok[r] && kb < K) vb = to_acc(Bz[row_off(db, kb) + boff[r]]);
      Bs[bk[r]][bn[r]] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mac(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* Cz = C + z * dc.sz;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const long long ro = row_off(dc, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) store(Cz + ro + col_off(dc, n), alpha * acc[i][j]);
    }
  }
}

Operand unpack(const long long* d) {
  Operand o;
  o.sz = d[0];
  o.rblk = (int)d[1]; o.ro = d[2]; o.ri = d[3];
  o.cblk = (int)d[4]; o.co = d[5]; o.ci = d[6];
  return o;
}

template <typename T, typename Acc>
void launch(const void* A, const void* B, void* C, int M, int N, int K, int Z,
            double alpha, const Operand& da, const Operand& db,
            const Operand& dc, cudaStream_t stream) {
  const int a_kfast = da.ci == 1;
  const int b_kfast = db.ri == 1 && db.ci != 1;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Z);
  block_gemm_kernel<T, Acc><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, N, K, static_cast<Acc>(alpha), da, db, dc, a_kfast, b_kfast);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  desc: 21 int64 values, seven
// (sz, rblk, ro, ri, cblk, co, ci) for each of A, B, C, in elements.  Returns
// the cudaError_t of the launch (0 on success); 1000 for an unknown dtype.
extern "C" int block_gemm_launch(int dtype, const void* A, const void* B,
                                 void* C, int M, int N, int K, int Z,
                                 double alpha, const long long* desc,
                                 void* stream) {
  const Operand da = unpack(desc), db = unpack(desc + 7), dc = unpack(desc + 14);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float, float>(A, B, C, M, N, K, Z, alpha, da, db, dc, s); break;
    case 1: launch<__nv_bfloat16, float>(A, B, C, M, N, K, Z, alpha, da, db, dc, s); break;
    case 2: launch<double, double>(A, B, C, M, N, K, Z, alpha, da, db, dc, s); break;
    default: return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}
