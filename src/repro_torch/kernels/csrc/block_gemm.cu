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
// A plain row-major matrix is the case rblk = M, cblk = K (one block).
//
// Types and instructions.  One kernel template, one inner product per type:
//   f64  -> DMMA  `mma.sync.aligned.m16n8k8.row.col.f64` (f64 accumulate).
//           sm_90 has the f64 shapes m8n8k4 and m16n8k{4,8,16}; nvcc 12.9
//           takes all four.  m16n8k8 is used: eight k per instruction, and
//           each lane's two k of a row are one 16-byte shared-memory load.
//   bf16 -> HMMA  `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
//           (f32 accumulate, bf16 store), fragments through `ldmatrix`.
//   f32  -> FMA   units, an 8x8 register tile per thread.  TF32 would keep
//           about three digits; the f32 sweep refuses it
//           (`core/pselinv_dist.py` guards `allow_tf32`), so f32 stays off
//           the tensor cores.
// The TPU kernel keeps an f32 accumulator even for f64 input
// (`block_gemm.py:67`); this one accumulates f64 in f64, because the engine's
// contract is f64 within 1e-12 of the dense oracle.  alpha is applied once,
// at the store, in the accumulate type.
//
// Tiles (chosen in Python by `block_gemm.plan`, passed in, checked here):
//   f64   BM=64,  BK=32, 4 warps (2x2, a warp owns 32 x BN/2), 2 stages
//   bf16  BM=64,  BK=32, 4 warps (2x2, a warp owns 32 x BN/2), 3 stages
//   f32   BM=128, BK=16, 2*BN threads (each 8x8 outputs), 3 stages
// with BN = b (96 or 128) on the sweep's level product, so a level with one
// supernode reads its A^-1 row panel once, and BN in {64, 96, 128} by N on
// row-major stacks.  BK divides 96 and 128, so a K slab never straddles a
// column block: one block offset per slab, contiguous 16-byte copies.  Two
// f64 blocks share an SM (80-98 KB of shared memory, up to 255 registers):
// at FEM nk = 1 (M = 3072, N = 96, Z = 8) that is 384 blocks on 264 slots.
// On the card, 8 warps of 32 x 24 each, or BK = 16 with 3 stages, ran slower
// than this (smaller warp tiles read more shared memory per DMMA).
//
// Staging.  A ring of K slabs in shared memory, in the input type, filled
// with `cp.async` 16-byte copies (rows past M or N zero-filled) when the
// operand is K-contiguous and 16-byte aligned -- both operands are, on the
// main path (A: ci = 1; B: ri = 1, the `row.col` layout mma.sync takes).
// Each thread keeps the base pointers of the rows it copies in registers;
// only the K offset changes per slab.  Anything else -- the row-major
// entry's N-contiguous B, rows that are not a multiple of 16 bytes
// (33x17x129), misaligned views -- goes through guarded element copies of
// the same kernel into the same shared layout, zero-filled at every edge
// (cp.async of 8 or 4 bytes for f64 and f32, so that path is pipelined too;
// register loads for bf16), with the tile's row offsets read from shared
// memory.  Shared rows are padded (bf16, f32) or XOR-swizzled (f64: bit 2
// of the 16-byte chunk index flips on odd rows) so that the fragment reads
// -- ldmatrix for bf16, 16-byte loads for f64 and f32 -- hit distinct
// banks.  Dynamic shared memory is raised per instance with
// cudaFuncSetAttribute.
//
// The struct mask.  On the level product a rank's U^ row block k keeps few
// of its nbc column blocks j: the FEM setting's 35 levels keep 4,920 of
// 65,024 (rank, k, j) blocks (7.57 %, at most 8 of 64 a row).  Given the
// mask (`mask` non-null; BN = b, so an N tile is one k), a block reads its
// (z, k) row of it, compacts the kept j into shared memory by a warp
// ballot, and runs the K loop over their slabs only: the product with
// where(mask, U^, 0), bit for bit, in 13.2x fewer multiply-adds there.
// Without it (the row-major entry, any caller that gives none) the loop
// spans K.
//
// What bounds it.  At the main-path shapes of the FEM setting (P = 8 ranks,
// m = nbr*b = 3072, k = nbc*b = 6144, n = nk*96 with nk = 1..14) the dense
// work is 2*m*n*k flops against m*k reads of A^-1 per rank: n/4 flops per
// byte of A^-1 in f64, n/2 in f32, n in bf16.  Against H100 SXM peaks
// (3.35 TB/s; 67 TFLOP/s f64 on DMMA, 67 TFLOP/s f32 on FMA, 989 TFLOP/s
// bf16) the ridge sits near n = 80 in f64, n = 40 in f32 and n = 295 in
// bf16.  So every dense f64 launch (n >= 96) is bound by DMMA issue; bf16
// launches with nk <= 3 are bound by reading A^-1 (which BN = b reads once)
// and the wide ones by HMMA, where mma.sync tops out well below the 989
// TFLOP/s that needs wgmma.  The dense loop reaches a bit over half of the
// DMMA peak (PERF.md): its fragments come from shared memory through
// 16-byte loads, 10 per 12 DMMAs per warp.  The masked loop is short (3 to
// 24 slabs of 32 at b = 96), so each block's pipeline fill and its 64 x b
// store of the partials weigh more against its multiply-adds, and each
// kept A^-1 column panel is read by every k that keeps it (through L2).
//
// Checked on the card by `chip_smoke.py` (DMMA in every f64 instance and
// HMMA in every bf16 one, counted with `cuobjdump -sass` on the built
// library; ptxas registers and spills per instance) and by
// `PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`,
// run in the same chip call.
//
// Determinism.  Each output element is summed by one thread (one mma
// accumulator slot) in one fixed K order: no split-K, no atomics.  The tile
// choice never depends on Z, so item z of a batched launch is bitwise equal
// to the same item launched alone; the masked loop keeps the dense loop's
// ascending K order.  Left to later work: the row side of the mask (only
// the rows in the struct of the level's supernodes are needed, 12x fewer
// again on FEM, but the partial region's other rows are read downstream),
// taking the U^ gather indices into the kernel, and wgmma + TMA for bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void dmma(double* c, const double* a,
                                     const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void hmma(float* c, const unsigned* a,
                                     const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// ---- one tile's inner product per type ------------------------------------
// Each core owns its accumulators, knows its shared layout (`at(row, k)`:
// element offset of (row, k) in a tile of rows x BK) and runs one K slab.

// f64 on DMMA m16n8k8.  Fragment slots (PTX ISA): A a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B b0 (t, g), b1 (t+4, g); C c0/c1 (g, 2t/2t+1),
// c2/c3 (g+8, ...), with g = lane/4, t = lane%4.  Slots t and t+4 of k step
// kk carry logical k = kk*8 + 2t and 2t+1 (one permutation on both operands,
// so the product is unchanged): a lane's two k of a row are adjacent, one
// 16-byte load.  Rows are 16 f64 = eight 16-byte chunks; chunk c of row r
// lies at c ^ ((r & 1) << 2), so the 8 lanes of a quarter-warp (rows g, g+1;
// chunks t) read 8 distinct chunks.
template <int BN>
struct DmmaCore {
  using T = double;
  using Acc = double;
  static constexpr int BM = 64, BK = 32, NT = 128, STAGES = 2;
  static constexpr int LD = BK;
  static constexpr int NTL = BN / 16;        // 8-wide n tiles per warp
  double acc[2][NTL][4];

  __device__ static int at(int r, int k) {
    return r * LD + (((k >> 1) ^ ((r & 1) << 2)) << 1) + (k & 1);
  }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  }
  __device__ void slab(const double* As, const double* Bs, int lane,
                       int warp) {
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      double a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        const double2 lo = *reinterpret_cast<const double2*>(As + at(r, kk * 8 + 2 * t));
        const double2 hi = *reinterpret_cast<const double2*>(As + at(r + 8, kk * 8 + 2 * t));
        a[i][0] = lo.x; a[i][2] = lo.y; a[i][1] = hi.x; a[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const double2 w = *reinterpret_cast<const double2*>(
            Bs + at(wn + j * 8 + g, kk * 8 + 2 * t));
        const double b[2] = {w.x, w.y};
#pragma unroll
        for (int i = 0; i < 2; ++i) dmma(acc[i][j], a[i], b);
      }
    }
  }
  template <typename F>
  __device__ void each(int lane, int warp, F f) const {
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm + i * 16 + g + 8 * (e >> 1), wn + j * 8 + 2 * t + (e & 1),
            acc[i][j][e]);
  }
};

// bf16 on HMMA m16n8k16 with ldmatrix.  Rows are 32 bf16 padded to 40 (80
// bytes): the 8 row addresses of one ldmatrix phase fall on 8 distinct
// 16-byte bank groups.  B tiles are [n][k] (K rows, "col" operand): ldmatrix
// without .trans yields the B fragment directly.
template <int BN>
struct HmmaCore {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int BM = 64, BK = 32, NT = 128, STAGES = 3;
  static constexpr int LD = BK + 8;
  static constexpr int NTL = BN / 16;
  float acc[2][NTL][4];

  __device__ static int at(int r, int k) { return r * LD + k; }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ void slab(const T* As, const T* Bs, int lane, int warp) {
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], As + at(wm + i * 16 + (lane & 15),
                                  kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int jj = 0; jj < NTL / 2; ++jj) {
        unsigned b[4];
        ldmatrix_x4(b, Bs + at(wn + jj * 16 + (lane >> 4) * 8 + (lane & 7),
                               kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          hmma(acc[i][2 * jj], a[i], b);
          hmma(acc[i][2 * jj + 1], a[i], b + 2);
        }
      }
    }
  }
  template <typename F>
  __device__ void each(int lane, int warp, F f) const {
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BN / 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm + i * 16 + g + 8 * (e >> 1), wn + j * 8 + 2 * t + (e & 1),
            acc[i][j][e]);
  }
};

// f32 on the FMA units: thread (tx, ty) of a (BN/8) x 16 grid owns rows
// ty + 16i and columns tx + (BN/8)j, i, j < 8.  Rows are 16 f32 padded to 20
// (80 bytes); per 4 k a thread loads 8 A and 8 B rows as 16-byte vectors
// (A broadcast across tx) for 256 multiply-adds, in k order.
template <int BN>
struct FmaCore {
  using T = float;
  using Acc = float;
  static constexpr int BM = 128, BK = 16, NT = 2 * BN, STAGES = 3;
  static constexpr int LD = BK + 4;
  static constexpr int NTX = BN / 8;
  float acc[8][8];

  __device__ static int at(int r, int k) { return r * LD + k; }
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void slab(const float* As, const float* Bs, int lane, int warp) {
    const int tid = warp * 32 + lane;
    const int tx = tid % NTX, ty = tid / NTX;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + at(ty + 16 * i, k4));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + at(tx + NTX * j, k4));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = __fmaf_rn(a[i].x, b.x, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].y, b.y, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].z, b.z, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  template <typename F>
  __device__ void each(int lane, int warp, F f) const {
    const int tid = warp * 32 + lane;
    const int tx = tid % NTX, ty = tid / NTX;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(ty + 16 * i, tx + NTX * j, acc[i][j]);
  }
};

template <typename T, int BN> struct CoreOf;
template <int BN> struct CoreOf<double, BN> { using type = DmmaCore<BN>; };
template <int BN> struct CoreOf<__nv_bfloat16, BN> { using type = HmmaCore<BN>; };
template <int BN> struct CoreOf<float, BN> { using type = FmaCore<BN>; };

// ---- staging: one K slab of one operand into shared memory ----------------
// Rows of the staged tile are A's rows (m) or B's columns (n); k runs along
// each row.  `async`: 16-byte cp.async copies along k (the operand is
// K-contiguous and aligned; the caller checked).  Otherwise guarded element
// copies -- cp.async of one element for f64 and f32, loads through
// registers for bf16 -- with `kfast` saying whether k or the row index is
// the operand's contiguous one, so consecutive threads read nearby
// addresses either way.
template <typename Core, int ROWS>
__device__ __forceinline__ void stage_async(
    typename Core::T* dst, const typename Core::T* const* rowp, long long koff,
    int r0, int rmax, int tid) {
  using T = typename Core::T;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = Core::BK / VEC;        // 16-byte chunks per row
  constexpr int PER = (ROWS * CPR + Core::NT - 1) / Core::NT;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int c = tid + p * Core::NT;
    const int r = c / CPR, k = (c % CPR) * VEC;
    if (c < ROWS * CPR)
      cp_async16(dst + Core::at(r, k), rowp[p] + koff + k, r0 + r < rmax);
  }
}

// The (row, k) of element e of a ROWS x BK slab in the guarded path.  With
// k the operand's contiguous index, k runs fastest; otherwise a warp takes 8
// rows x 4 k (rows fastest): global reads stay in 32-byte pieces and the
// shared stores, which walk down the tile's rows, spread over 8 bank groups.
template <int ROWS, int BK>
__device__ __forceinline__ void guarded_rk(int e, bool kfast, int& r, int& k) {
  if (kfast) {
    r = e / BK;
    k = e % BK;
  } else {
    const int rl = e & 7, kl = (e >> 3) & 3, q = e >> 5;
    r = (q % (ROWS / 8)) * 8 + rl;
    k = (q / (ROWS / 8)) * 4 + kl;
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(full ? BYTES : 0));
}

// the offset of index kk along k: one multiply where the operand's k axis is
// one block (the row-major entry), the blocked formula otherwise
__device__ __forceinline__ long long k_off(const Operand& d, int kk, bool is_a) {
  const int blk = is_a ? d.cblk : d.rblk;
  const long long in = is_a ? d.ci : d.ri;
  if (kk < blk) return kk * in;
  return is_a ? col_off(d, kk) : row_off(d, kk);
}

template <typename Core, int ROWS, bool IS_A>
__device__ __forceinline__ void stage_guarded(
    typename Core::T* dst, const typename Core::T* base, const long long* offs,
    const Operand& d, int k0, int K, bool kfast, int tid) {
  using T = typename Core::T;
  constexpr int BK = Core::BK, N = ROWS * BK;
  constexpr int PER = (N + Core::NT - 1) / Core::NT;
  static_assert(ROWS % 8 == 0 && BK % 4 == 0, "guarded map");
  // the element's address, or null off the edges (rows: offs < 0; k >= K)
  auto src = [&](int e) -> const T* {
    int r, k;
    guarded_rk<ROWS, BK>(e, kfast, r, k);
    const long long off = offs[r];
    if (off < 0 || k0 + k >= K) return nullptr;
    return base + off + k_off(d, k0 + k, IS_A);
  };
  auto slot = [&](int e) {
    int r, k;
    guarded_rk<ROWS, BK>(e, kfast, r, k);
    return dst + Core::at(r, k);
  };
  if constexpr (sizeof(T) >= 4) {
    // element-wise cp.async (4 or 8 bytes, zero-filled off the edges):
    // pipelined like the 16-byte path, no registers held
#pragma unroll 1
    for (int e = tid; e < N; e += Core::NT) {
      const T* g = src(e);
      cp_async_elem<sizeof(T)>(slot(e), g ? g : base, g != nullptr);
    }
  } else {
    // 2-byte elements (cp.async copies 4 bytes at least): through
    // registers, 8 loads in flight per thread before their stores
    constexpr int G = PER < 8 ? PER : 8;
#pragma unroll 1
    for (int p0 = 0; p0 < PER; p0 += G) {
      T v[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int e = tid + (p0 + i) * Core::NT;
        const T* g = e < N ? src(e) : nullptr;
        v[i] = g ? *g : T(0.0f);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int e = tid + (p0 + i) * Core::NT;
        if (e < N) *slot(e) = v[i];
      }
    }
  }
}

// The level product's struct mask: item z keeps column block j of B's k-th
// column block (U^ block (k, j)) where p[(z % pm)*sz + k*sk + j*sj] is
// nonzero, bool bytes read where they lie; nbc column blocks of K.
struct Mask {
  const unsigned char* p;
  long long sz, sk, sj;
  int pm, nbc;
};

// MASKED: each N tile is one k (BN = B's column block, checked at launch);
// the K loop runs over the slabs of the column blocks j that the mask keeps
// for (z, k), in ascending order, and over nothing else.
template <typename T, int BN, bool MASKED>
__global__ void __launch_bounds__(sizeof(T) == 4 ? 2 * BN : 128)  // Core::NT
block_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int M, int N, int K,
                  typename CoreOf<T, BN>::type::Acc alpha, Operand da,
                  Operand db, Operand dc, int a_async, int b_async,
                  Mask mk) {
  using Core = typename CoreOf<T, BN>::type;
  constexpr int BM = Core::BM, BK = Core::BK, NT = Core::NT;
  constexpr int STAGES = Core::STAGES, LD = Core::LD;
  static_assert(NT == (sizeof(T) == 4 ? 2 * BN : 128), "launch bounds");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int APER = (BM * (BK / VEC) + NT - 1) / NT;
  constexpr int BPER = (BN * (BK / VEC) + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  // after the stages: the element offset of each of the tile's A rows and
  // B columns at k = 0 (-1 past M or N), for the guarded path
  long long* offs = reinterpret_cast<long long*>(
      smem_raw + (size_t)STAGES * (BM + BN) * LD * sizeof(T));
  // after the offsets, masked: the kept column blocks j, ascending
  int* keep = reinterpret_cast<int*>(offs + BM + BN);
  __shared__ int nkeep;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long z = blockIdx.z;
  const T* Az = A + z * da.sz;
  const T* Bz = B + z * db.sz;
  if constexpr (MASKED) {
    // warp 0 reads the (z, k) row of the mask 32 bytes at a time and
    // compacts it by ballot: a kept j's place is the kept lanes below it
    if (warp == 0) {
      const unsigned char* row =
          mk.p + (z % mk.pm) * mk.sz + (long long)blockIdx.x * mk.sk;
      int n = 0;
      for (int j0 = 0; j0 < mk.nbc; j0 += 32) {
        const int j = j0 + lane;
        const bool on = j < mk.nbc && row[j * mk.sj] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        if (on) keep[n + __popc(bal & ((1u << lane) - 1u))] = j;
        n += __popc(bal);
      }
      if (lane == 0) nkeep = n;
    }
  }
  for (int i = tid; i < BM + BN; i += NT) {
    const int m = m0 + i, n = n0 + i - BM;
    offs[i] = i < BM ? (m < M ? row_off(da, m) : -1)
                     : (n < N ? col_off(db, n) : -1);
  }
  // and the same for the cp.async path, in registers: the rows (A) and
  // columns (B) this thread copies, at k = 0 (row 0 past the edge, where
  // the copy is a zero-fill); a slab adds one offset
  const T* arow[APER];
  const T* brow[BPER];
#pragma unroll
  for (int p = 0; p < APER; ++p) {
    const int r = m0 + (tid + p * NT) / (BK / VEC);
    arow[p] = Az + (r < M ? row_off(da, r) : 0);
  }
#pragma unroll
  for (int p = 0; p < BPER; ++p) {
    const int r = n0 + (tid + p * NT) / (BK / VEC);
    brow[p] = Bz + (r < N ? col_off(db, r) : 0);
  }
  __syncthreads();
  const bool a_kfast = da.ci == 1, b_kfast = db.ri == 1;

  // masked: spb slabs a kept column block, and slab s at k0 of block
  // keep[s / spb]; a skipped block is a whole number of slabs (BK divides
  // its width), so every output element takes the dense loop's sequence of
  // multiply-adds less those of exact zeros
  const int spb = MASKED ? da.cblk / BK : 1;
  auto load = [&](int slab, int st) {
    T* As = smem + st * (BM + BN) * LD;
    T* Bs = As + BM * LD;
    const int k0 = MASKED ? keep[slab / spb] * da.cblk + (slab % spb) * BK
                          : slab * BK;
    if (a_async)   // one block offset per slab: BK divides cblk
      stage_async<Core, BM>(As, arow, col_off(da, k0), m0, M, tid);
    else
      stage_guarded<Core, BM, true>(As, Az, offs, da, k0, K, a_kfast, tid);
    if (b_async)
      stage_async<Core, BN>(Bs, brow, row_off(db, k0), n0, N, tid);
    else
      stage_guarded<Core, BN, false>(Bs, Bz, offs + BM, db, k0, K, b_kfast,
                                     tid);
  };

  Core core;
  core.zero();
  // a tile whose k keeps no block runs no slab and stores zeros
  const int nslab = MASKED ? nkeep * spb : (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nslab; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();       // slab kt landed; slab kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nslab) load(nxt, nxt % STAGES);
    cp_async_commit();
    const T* As = smem + (kt % STAGES) * (BM + BN) * LD;
    core.slab(As, As + BM * LD, lane, warp);
  }
  cp_async_wait<0>();

  T* Cz = C + z * dc.sz;
  core.each(lane, warp, [&](int r, int c, typename Core::Acc v) {
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) store(Cz + row_off(dc, m) + col_off(dc, n), alpha * v);
  });
}

Operand unpack(const long long* d) {
  Operand o;
  o.sz = d[0];
  o.rblk = (int)d[1]; o.ro = d[2]; o.ri = d[3];
  o.cblk = (int)d[4]; o.co = d[5]; o.ci = d[6];
  return o;
}

bool aligned(const void* p, const long long* s, int n, int vec) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (s[i] % vec) return false;
  return true;
}

template <typename T, int BN, bool MASKED>
int launch(const void* A, const void* B, void* C, int M, int N, int K, int Z,
           double alpha, const Operand& da, const Operand& db,
           const Operand& dc, int a_async, int b_async, const Mask& mk,
           cudaStream_t stream) {
  using Core = typename CoreOf<T, BN>::type;
  constexpr int VEC = 16 / sizeof(T);
  // the async path's preconditions, as `block_gemm.plan` decides them; a
  // misaligned cp.async would fault the context, so they are checked again
  const long long sa[4] = {da.sz, da.ro, da.ri, da.co};
  const long long sb[4] = {db.sz, db.ro, db.ci, db.co};
  if (a_async && !(da.ci == 1 && da.cblk % Core::BK == 0 &&
                   K % Core::BK == 0 && aligned(A, sa, 4, VEC)))
    return 1001;
  if (b_async && !(db.ri == 1 && db.rblk % Core::BK == 0 &&
                   K % Core::BK == 0 && aligned(B, sb, 4, VEC)))
    return 1001;
  // masked: an N tile is one k (B's column blocks are BN wide), K is nbc
  // column blocks of A and row blocks of B alike, and BK divides them
  if (MASKED && !(mk.p && mk.pm > 0 && db.cblk == BN && N % BN == 0 &&
                  da.cblk == db.rblk && da.cblk % Core::BK == 0 &&
                  (long long)mk.nbc * da.cblk == K))
    return 1002;
  const size_t smem = (size_t)Core::STAGES * (Core::BM + BN) * Core::LD * sizeof(T) +
                      (size_t)(Core::BM + BN) * sizeof(long long) +
                      (MASKED ? (size_t)mk.nbc * sizeof(int) : 0);
  auto kern = block_gemm_kernel<T, BN, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + Core::BM - 1) / Core::BM, Z);
  kern<<<grid, Core::NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, N, K, static_cast<typename Core::Acc>(alpha), da, db, dc, a_async,
      b_async, mk);
  return static_cast<int>(cudaGetLastError());
}

// the compiled tiles: BN in {64, 96, 128}, BM and BK fixed per type; the
// masked K loop at BN in {96, 128}, the level product's b
template <typename T>
int launch_bn(int bm, int bn, int bk, const void* A, const void* B, void* C,
              int M, int N, int K, int Z, double alpha, const Operand& da,
              const Operand& db, const Operand& dc, int a_async, int b_async,
              const Mask& mk, cudaStream_t s) {
  using C64 = typename CoreOf<T, 64>::type;
  if (bm != C64::BM || bk != C64::BK) return 1000;
  const bool m = mk.p != nullptr;
  switch (bn) {
    case 64:
      if (m) return 1000;
      return launch<T, 64, false>(A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    case 96:
      if (m) return launch<T, 96, true>(A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
      return launch<T, 96, false>(A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    case 128:
      if (m) return launch<T, 128, true>(A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
      return launch<T, 128, false>(A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    default: return 1000;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float64.  (bm, bn, bk): the tile
// `block_gemm.plan` chose (one of the compiled instances); a_async/b_async:
// stage that operand with cp.async (else guarded element loads).  desc: 21
// int64 values, seven (sz, rblk, ro, ri, cblk, co, ci) for each of A, B, C,
// in elements.  mask: null for the dense product, else the level product's
// struct mask, (pm, nk, nbc) bool bytes at strides mstride (three int64,
// in bytes), item z reading row z % pm.  Returns the cudaError_t of the
// launch (0 on success); 1000 for an unknown dtype or tile, 1001 for an
// async flag on an operand that is not K-contiguous and 16-byte aligned,
// 1002 for a mask on a product whose N tile is not one column block.
extern "C" int block_gemm_launch(int dtype, int bm, int bn, int bk,
                                 int a_async, int b_async, const void* A,
                                 const void* B, void* C, int M, int N, int K,
                                 int Z, double alpha, const long long* desc,
                                 const void* mask, int pm, int nbc,
                                 const long long* mstride, void* stream) {
  const Operand da = unpack(desc), db = unpack(desc + 7), dc = unpack(desc + 14);
  Mask mk{static_cast<const unsigned char*>(mask), 0, 0, 0, pm, nbc};
  if (mask) {
    mk.sz = mstride[0];
    mk.sk = mstride[1];
    mk.sj = mstride[2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bn<float>(bm, bn, bk, A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    case 1: return launch_bn<__nv_bfloat16>(bm, bn, bk, A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    case 2: return launch_bn<double>(bm, bn, bk, A, B, C, M, N, K, Z, alpha, da, db, dc, a_async, b_async, mk, s);
    default: return 1000;
  }
}
