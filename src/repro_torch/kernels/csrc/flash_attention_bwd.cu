// Flash attention backward for Hopper (sm_90a): the gradient of
// `flash_attention.cu`'s forward, out = softmax(q k^T * scale) v per (b, h),
// with the element-level causal mask when asked.
//
// The TPU kernel `repro/kernels/flash_attention.py:flash_attention_pallas`
// has no backward: the JAX package differentiates its chunked jnp attention,
// whose `jax.checkpoint` recomputes each (q chunk x kv chunk) score tile
// and never stores S x S.  This kernel keeps that property the
// FlashAttention-2 way: the forward writes each row's log-sum-exp `lse`
// (B, H, S) in f32, and the backward recomputes P = exp(s * scale - lse)
// tile by tile.  Three launches, each summed in one fixed order (no atomics,
// no split over q or keys): the result is bitwise reproducible.
//
//   1. `flash_bwd_dot`: D = rowsum(dO o O) in f32, one warp a row.
//   2. dK/dV: one block per (b*h, key tile), looping over the q tiles
//      (under causal masking only those at or below the diagonal).  For
//      each q tile it recomputes S = Q K^T and dP = dO V^T, then
//      P = exp(S * scale - lse) and dS = P o (dP - D), and accumulates
//      dV += P^T dO and dK += dS^T Q in registers (f32); dK is scaled once
//      at the end.
//   3. dQ: one block per (b*h, q tile), looping over the key tiles up to
//      the diagonal: the same S, dP and dS, and dQ += dS K, scaled once at
//      the end.
//
// Three routes, chosen by `flash_attention_bwd.plan`: bf16 on the tensor
// cores by `wgmma` fed by TMA (`wgmma_tma`, namespace `wgt` below) when
// every operand is 16-byte aligned, else by `mma.sync` with guarded element
// loads (`hmma_guarded`, namespace `hmma`); f32 on the FMA units (`fma_f32`,
// the kernels right below: TF32 would keep about three digits).  dq, dk, dv
// are rounded once to the input type; `kernels/ref.py:flash_attention_bwd_ref`
// is the same arithmetic in plain PyTorch.
//
// What bounds it.  Five products of 2 * pairs * hd operations per (b, h)
// (pairs = S^2, or S (S + 1) / 2 causal; S and dP are computed twice, in the
// dK/dV and the dQ kernel: seven done) against q, k, v, out, dO read and
// dq, dk, dv written once: far above the ridge, so bound by operations on
// the tensor cores, whose 989 TFLOP/s only `wgmma` reaches, and by the
// exponentials between the products.  The note above namespace `wgt` says
// what its design does about that and what is left.
//
// The f32 FMA kernel.  Tiles: 64 q rows by BK keys, BK = 64 at hd 64 and 32
// at hd 128, 128 threads; Q, dO, K and V tiles in shared memory as f32 rows
// padded by one word (lanes reading eight rows at one column hit eight
// banks), P and dS tiles likewise, 100 KB (hd 64) or 116 KB (hd 128)
// dynamic.  Each thread owns 4 rows x BK/8 keys of the score tiles and
// 4 x 8 of the dK/dV (or 4 x hd/8 of the dQ) accumulators.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;      // in elements; the hd axis is contiguous
};

constexpr int BQ = 64;
constexpr int NT = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// D[(b*H + h)*S + s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: a warp a row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const T* __restrict__ dO, const T* __restrict__ O,
              float* __restrict__ D, int S, int H, int hd, Strides sdo,
              Strides so, long long rows) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows) return;                     // the whole warp leaves
  const long long bh = w / S;
  const int s = (int)(w % S), b = (int)(bh / H), h = (int)(bh % H);
  const T* a = dO + b * sdo.b + s * sdo.s + h * sdo.h;
  const T* c = O + b * so.b + s * so.s + h * so.h;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = __fmaf_rn(to_f(a[d]), to_f(c[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[w] = acc;
}

// ROWS rows of HD values from src + (r0 + r) * stride into dst[r][HD + 1]
// as f32; rows at or past S are zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride,
                                      int r0, int S, int tid) {
  for (int idx = tid; idx < ROWS * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    dst[r * (HD + 1) + c] = r0 + r < S ? to_f(src[(long long)(r0 + r) * stride + c]) : 0.f;
  }
}

template <int HD, int BK>
struct Tiles {
  static constexpr int LD = HD + 1;
  static constexpr int LP = BK + 1;
  static constexpr int SJ = BK / 8;          // keys of a thread: cg + 8j
};

// S = Q K^T and dP = dO V^T for rows r0..r0+3, keys cg + 8j of the tile,
// then P = exp(s * scale - lse) (0 where masked) and dS = P o (dP - D)
template <int HD, int BK>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* D_s,
                                       int r0, int cg, int q0, int k0, int S,
                                       float scale, int causal,
                                       float (&p)[4][BK / 8],
                                       float (&ds)[4][BK / 8]) {
  using L = Tiles<HD, BK>;
  constexpr int LD = L::LD, SJ = L::SJ;
  float dp[4][SJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) p[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; ++c) {
    float qv[4], ov[4], kv[SJ], vv[SJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(r0 + i) * LD + c];
      ov[i] = dOs[(r0 + i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      kv[j] = Ks[(cg + 8 * j) * LD + c];
      vv[j] = Vs[(cg + 8 * j) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        p[i][j] = __fmaf_rn(qv[i], kv[j], p[i][j]);
        dp[i][j] = __fmaf_rn(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int key = k0 + cg + 8 * j;
      const bool keep = row < S && key < S && (!causal || key <= row);
      const float pv = keep ? expf(p[i][j] * scale - lse_s[r0 + i]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - D_s[r0 + i]);
    }
  }
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ D,
               T* __restrict__ dk, T* __restrict__ dv, int S, int H,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
               Strides sdv, float scale, int causal) {
  using L = Tiles<HD, BK>;
  constexpr int LD = L::LD, LP = L::LP, SJ = L::SJ;
  constexpr int CG = 4 * NT / BK;            // column groups of dK / dV
  constexpr int DJ = HD / CG;                // columns a thread: dc + CG j
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][LD]
  float* dOs = Qs + BQ * LD;                 // [BQ][LD]
  float* Ks = dOs + BQ * LD;                 // [BK][LD]
  float* Vs = Ks + BK * LD;                  // [BK][LD]
  float* Ps = Vs + BK * LD;                  // [BQ][LP]
  float* dSs = Ps + BQ * LP;                 // [BQ][LP]
  float* lse_s = dSs + BQ * LP;              // [BQ]
  float* D_s = lse_s + BQ;                   // [BQ]

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4, cg = tid & 7;         // score tile
  const int kr0 = (tid / CG) * 4, dc = tid % CG;       // dK / dV
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* ob = dO + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * S;
  const float* Db = D + (long long)bh * S;

  stage<T, HD, BK>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S, tid);
  stage<T, HD, BK>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S, tid);

  float adk[4][DJ], adv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int q0 = causal ? (k0 / BQ) * BQ : 0; q0 < S; q0 += BQ) {
    __syncthreads();                         // the previous tiles are read
    stage<T, HD, BQ>(Qs, qb, sq.s, q0, S, tid);
    stage<T, HD, BQ>(dOs, ob, sdo.s, q0, S, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      lse_s[tid] = in ? lb[q0 + tid] : 0.f;
      D_s[tid] = in ? Db[q0 + tid] : 0.f;
    }
    __syncthreads();
    float p[4][SJ], ds[4][SJ];
    scores<HD, BK>(Qs, dOs, Ks, Vs, lse_s, D_s, r0, cg, q0, k0, S, scale,
                   causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        Ps[(r0 + i) * LP + cg + 8 * j] = p[i][j];
        dSs[(r0 + i) * LP + cg + 8 * j] = ds[i][j];
      }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's 64 rows, in row order
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * LP + kr0 + i];
        sv[i] = dSs[r * LP + kr0 + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[r * LD + dc + CG * j];
        qv[j] = Qs[r * LD + dc + CG * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          adv[i][j] = __fmaf_rn(pv[i], ov[j], adv[i][j]);
          adk[i][j] = __fmaf_rn(sv[i], qv[j], adk[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + kr0 + i;
    if (key >= S) continue;
    T* kr = dk + b * sdk.b + (long long)key * sdk.s + h * sdk.h;
    T* vr = dv + b * sdv.b + (long long)key * sdv.s + h * sdv.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      from_f(kr + dc + CG * j, adk[i][j] * scale);
      from_f(vr + dc + CG * j, adv[i][j]);
    }
  }
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ D,
             T* __restrict__ dq, int S, int H, Strides sq, Strides sk,
             Strides sv, Strides sdo, Strides sdq, float scale, int causal) {
  using L = Tiles<HD, BK>;
  constexpr int LD = L::LD, LP = L::LP, SJ = L::SJ;
  constexpr int DJ = HD / 8;                 // dQ columns a thread: cg + 8j
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][LD]
  float* dOs = Qs + BQ * LD;                 // [BQ][LD]
  float* Ks = dOs + BQ * LD;                 // [BK][LD]
  float* Vs = Ks + BK * LD;                  // [BK][LD]
  float* dSs = Vs + BK * LD;                 // [BQ][LP]
  float* lse_s = dSs + BQ * LP;              // [BQ]
  float* D_s = lse_s + BQ;                   // [BQ]

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4, cg = tid & 7;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  stage<T, HD, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  stage<T, HD, BQ>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
  if (tid < BQ) {
    const bool in = q0 + tid < S;
    lse_s[tid] = in ? lse[(long long)bh * S + q0 + tid] : 0.f;
    D_s[tid] = in ? D[(long long)bh * S + q0 + tid] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                         // the previous K/V tile is read
    stage<T, HD, BK>(Ks, kb, sk.s, k0, S, tid);
    stage<T, HD, BK>(Vs, vb, sv.s, k0, S, tid);
    __syncthreads();
    float p[4][SJ], ds[4][SJ];
    scores<HD, BK>(Qs, dOs, Ks, Vs, lse_s, D_s, r0, cg, q0, k0, S, scale,
                   causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) dSs[(r0 + i) * LP + cg + 8 * j] = ds[i][j];
    __syncwarp();                            // dS rows are this warp's own
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float sv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(r0 + i) * LP + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[t * LD + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = __fmaf_rn(sv[i], kv[j], acc[i][j]);
    }
    __syncwarp();                            // dS is read before it is rewritten
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    T* out = dq + b * sdq.b + (long long)row * sdq.s + h * sdq.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) from_f(out + cg + 8 * j, acc[i][j] * scale);
  }
}

template <int HD, int BK>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (HD + 1) +
                          (size_t)2 * BQ * (BK + 1) + 2 * BQ);
}
template <int HD, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (HD + 1) +
                          (size_t)BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int HD, int BK>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dO,
           const float* lse, float* D, T* dq, T* dk, T* dv, int B, int S,
           int H, const Strides* st, float scale, int causal,
           cudaStream_t stream) {
  // st: q, k, v, out, dO, dq, dk, dv
  const long long rows = (long long)B * H * S;
  flash_bwd_dot<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      dO, o, D, S, H, HD, st[4], st[3], rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto kv = flash_bwd_dkdv<T, HD, BK>;
  const size_t s1 = dkdv_smem<HD, BK>();
  e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(B * H, (S + BK - 1) / BK), NT, s1, stream>>>(
      q, k, v, dO, lse, D, dk, dv, S, H, st[0], st[1], st[2], st[4], st[6],
      st[7], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto kq = flash_bwd_dq<T, HD, BK>;
  const size_t s2 = dq_smem<HD, BK>();
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3(B * H, (S + BQ - 1) / BQ), NT, s2, stream>>>(
      q, k, v, dO, lse, D, dq, S, H, st[0], st[1], st[2], st[4], st[5],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}


// ---- bf16 on mma.sync, for operands TMA cannot take ------------------------
//
// `hmma_guarded`: the three steps with every product on
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, as the forward's
// tensor-core kernel, for operands whose base address or a stride is not
// 16-byte aligned.  dK/dV: a block of 4 warps owns 64 keys, each warp 16,
// and computes S^T = K Q^T and dP^T = V dO^T for its keys against a tile of
// BQ q rows (K and V rows as A fragments, Q and dO rows as "col" B
// fragments, all by ldmatrix from bf16 shared tiles), so that P^T and dS^T
// sit in C fragments whose rows are its keys: rounded to bf16 pairs they
// are the A fragments of dV += P^T dO and dK += dS^T Q, with dO and Q
// through ldmatrix.trans.  dQ: a block of 4 warps owns 64 q rows, each warp
// 16, loops over BK-key tiles: S = Q K^T and dP = dO V^T (Q and dO as A
// fragments kept in registers, K and V rows as B fragments), then
// dQ += dS K with K through ldmatrix.trans.  P and dS are rounded to bf16
// as mma operands (`ref.flash_attention_bwd_ref` rounds them the same way);
// every sum is f32.  Tiles: BQ = 64 (hd 64) or 32 (hd 128) q rows a dK/dV
// step, BK = 64 or 32 keys a dQ step, so S and dP take at most 64
// registers a thread beside the hd-wide accumulators.  Tiles are staged by
// element loads; rows at or past S are zero.
namespace hmma {

typedef __nv_bfloat16 bf16;
constexpr int NT = 128;            // 4 warps

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma(float* c, const unsigned* a,
                                    const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ROWS rows of HD values, row r at src + (r0 + r) * stride, into dst[r][LD];
// rows at or past S zero
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int S,
                                          int tid) {
  constexpr int LD = HD + 8;
  for (int e = tid; e < ROWS * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] = r0 + r < S ? src[(long long)(r0 + r) * stride + d]
                                 : __float2bfloat16(0.f);
  }
}

// C[16 x 8N] += A[16 rows of this warp, at a0 in a [.][LD] tile] times the
// B rows b0.. of a [.][LD] tile, as "col" operands, over HD
template <int HD, int N>
__device__ __forceinline__ void rows_times_rows(float (&c)[N][4], const bf16* a0,
                                               const bf16* b0, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    unsigned af[4];
    ldsm_x4(af, a0 + (lane & 15) * LD + kd * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < N / 2; ++jj) {
      unsigned bf[4];
      ldsm_x4(bf, b0 + (jj * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                      kd * 16 + ((lane >> 3) & 1) * 8);
      mma(c[2 * jj], af, bf);
      mma(c[2 * jj + 1], af, bf + 2);
    }
  }
}

// C[16 x HD] += A (N/2 k16 tiles of C fragments, rounded to bf16) times the
// rows k0.. of a [.][LD] tile as the k axis (ldmatrix.trans)
template <int HD, int N>
__device__ __forceinline__ void frags_times_tile(float (&c)[HD / 8][4],
                                                const float (&a)[N][4],
                                                const bf16* b0, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kt = 0; kt < N / 2; ++kt) {
    const unsigned pa[4] = {pack(a[2 * kt][0], a[2 * kt][1]),
                            pack(a[2 * kt][2], a[2 * kt][3]),
                            pack(a[2 * kt + 1][0], a[2 * kt + 1][1]),
                            pack(a[2 * kt + 1][2], a[2 * kt + 1][3])};
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b0 + (kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                            dd * 16 + (lane >> 4) * 8);
      mma(c[2 * dd], pa, bf);
      mma(c[2 * dd + 1], pa, bf + 2);
    }
  }
}

// dK/dV: a block per (b*h, 64 keys); BQ q rows a step
template <int HD, int BQ>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ D,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
            Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
            Strides sdv, float scale, int causal) {
  constexpr int BK = 64, LD = HD + 8, N = BQ / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* Vs = Ks + BK * LD;                        // [BK][LD]
  bf16* Qs = Vs + BK * LD;                        // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                        // [BQ][LD] (dO)
  float* ls = reinterpret_cast<float*>(Os + BQ * LD);  // [BQ]
  float* Ds = ls + BQ;                                 // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int w0 = k0 + warp * 16;                 // this warp's first key
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* ob = dO + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * S;
  const float* Db = D + (long long)bh * S;

  load_tile<HD, BK>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S, tid);
  load_tile<HD, BK>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S, tid);

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;

  for (int q0 = causal ? (k0 / BQ) * BQ : 0; q0 < S; q0 += BQ) {
    __syncthreads();                             // the previous tiles are read
    load_tile<HD, BQ>(Qs, qb, sq.s, q0, S, tid);
    load_tile<HD, BQ>(Os, ob, sdo.s, q0, S, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      ls[tid] = in ? lb[q0 + tid] : 0.f;
      Ds[tid] = in ? Db[q0 + tid] : 0.f;
    }
    __syncthreads();
    if (causal && q0 + BQ - 1 < w0) continue;    // every q above the keys
    float st[N][4], dp[N][4];                    // S^T, dP^T: 16 keys x BQ
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
    rows_times_rows<HD, N>(st, Ks + warp * 16 * LD, Qs, lane);
    rows_times_rows<HD, N>(dp, Vs + warp * 16 * LD, Os, lane);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = w0 + g + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1), row = q0 + c;
        const bool keep = row < S && key < S && (!causal || key <= row);
        const float p = keep ? expf(st[n][e] * scale - ls[c]) : 0.f;
        st[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Ds[c]);
      }
    frags_times_tile<HD, N>(adv, st, Os, lane);   // dV += P^T dO
    frags_times_tile<HD, N>(adk, dp, Qs, lane);   // dK += dS^T Q
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = w0 + g + 8 * r;
    if (key >= S) continue;
    bf16* kr = dk + b * sdk.b + (long long)key * sdk.s + h * sdk.h + 2 * t;
    bf16* vr = dv + b * sdv.b + (long long)key * sdv.s + h * sdv.h + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(kr + d * 8) = __floats2bfloat162_rn(
          adk[d][2 * r] * scale, adk[d][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vr + d * 8) =
          __floats2bfloat162_rn(adv[d][2 * r], adv[d][2 * r + 1]);
    }
  }
}

// dQ: a block per (b*h, 64 q rows); BK keys a step
template <int HD, int BK>
__global__ void __launch_bounds__(NT)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dq, int S, int H, Strides sq, Strides sk,
          Strides sv, Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int BQ = 64, LD = HD + 8, N = BK / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Os = Qs + BQ * LD;                        // [BQ][LD] (dO)
  bf16* Ks = Os + BQ * LD;                        // [BK][LD]
  bf16* Vs = Ks + BK * LD;                        // [BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int w0 = q0 + warp * 16;                  // this warp's first row
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<HD, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<HD, BQ>(Os, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
  float lr[2], Dr[2];                             // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    lr[r] = row < S ? lse[(long long)bh * S + row] : 0.f;
    Dr[r] = row < S ? D[(long long)bh * S + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int kt0 = 0; kt0 < kend; kt0 += BK) {
    __syncthreads();                             // the previous K/V tile is read
    load_tile<HD, BK>(Ks, kb, sk.s, kt0, S, tid);
    load_tile<HD, BK>(Vs, vb, sv.s, kt0, S, tid);
    __syncthreads();
    if (causal && kt0 > w0 + 15) continue;       // every key above the rows
    float s[N][4], dp[N][4];                     // 16 rows x BK keys
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_times_rows<HD, N>(s, Qs + warp * 16 * LD, Ks, lane);
    rows_times_rows<HD, N>(dp, Os + warp * 16 * LD, Vs, lane);
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, row = w0 + g + 8 * r;
        const int key = kt0 + n * 8 + 2 * t + (e & 1);
        const bool keep = row < S && key < S && (!causal || key <= row);
        const float p = keep ? expf(s[n][e] * scale - lr[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - Dr[r]);
      }
    frags_times_tile<HD, N>(acc, dp, Ks, lane);   // dQ += dS K
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= S) continue;
    bf16* out = dq + b * sdq.b + (long long)row * sdq.s + h * sdq.h + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(out + d * 8) = __floats2bfloat162_rn(
          acc[d][2 * r] * scale, acc[d][2 * r + 1] * scale);
  }
}

template <int HD, int BQ, int BK>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dO, const float* lse, float* D, bf16* dq, bf16* dk,
           bf16* dv, int B, int S, int H, const Strides* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const long long rows = (long long)B * H * S;
  flash_bwd_dot<bf16><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      dO, o, D, S, H, HD, st[4], st[3], rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kv = dkdv_kernel<HD, BQ>;
  const size_t s1 = sizeof(bf16) * (size_t)(2 * 64 + 2 * BQ) * LD +
                    sizeof(float) * 2 * BQ;
  e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(B * H, (S + 63) / 64), NT, s1, stream>>>(
      q, k, v, dO, lse, D, dk, dv, S, H, st[0], st[1], st[2], st[4], st[6],
      st[7], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kq = dq_kernel<HD, BK>;
  const size_t s2 = sizeof(bf16) * (size_t)(2 * 64 + 2 * BK) * LD;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3(B * H, (S + 63) / 64), NT, s2, stream>>>(
      q, k, v, dO, lse, D, dq, S, H, st[0], st[1], st[2], st[4], st[5], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hmma

// ---- bf16 on Hopper: wgmma fed by a TMA ring -------------------------------
//
// `wgmma_tma`, the route of every bf16 call whose operands are 16-byte
// aligned.  What bounds it is the tensor-core rate of its seven products
// and, between them, the exponentials (one MUFU op an element, 4096 a
// 64 x 64 tile, two thirds of that tile's product time on an SM).  What
// its design does about that:
//
//   * The products run on `wgmma.mma_async` (m64nNk16, f32 sums), the only
//     instruction that reaches the card's bf16 rate.  A consumer warpgroup
//     (4 warps) owns 64 rows of M; a block has NWG = 2 of them, so one
//     warpgroup's products run while the other is in its exponentials.
//       dK/dV (M = keys): S^T = K Q^T and dP^T = V dO^T against the Q and
//       dO tiles in shared memory, K-major; P^T and dS^T stay in registers,
//       rounded to bf16 A fragments (the accumulator layout of m64nN is
//       the A layout of the next product), for dV += P^T dO and
//       dK += dS^T Q, whose B (dO, Q) is read MN-major through the
//       transpose flag of a 16-bit B.  At hd 64 each warpgroup owns 64
//       keys and both of their accumulators, and holds its K and V as A
//       fragments (ldmatrix from the swizzled tiles, once), so that S^T
//       and dP^T read only their B from shared memory.  At hd 128 the two
//       64 x 128 f32 accumulators of one warpgroup leave ptxas too few of
//       its 240 registers (it spills and waits after every wgmma, whatever
//       the score tile), so the two warpgroups share the block's 64 keys:
//       one accumulates dV (S^T, P), the other dK (S^T, dP^T, dS): one S^T
//       product more a tile, K and V read from shared memory.
//       dQ (M = 64 q rows a warpgroup): S = Q K^T and dP = dO V^T with Q and
//       dO loaded once and held as A fragments, then dQ += dS K with dS
//       from registers and the K tile read MN-major.
//   * Tiles come by TMA (`cp.async.bulk.tensor.4d`) through rank-4 maps
//     {hd, H, S, B} with the caller's strides, so packed-qkv views and
//     local shards need no copy: 64-row boxes of 64 columns (128 bytes)
//     under the 128-byte swizzle that the wgmma descriptors read, two boxes
//     a row at hd 128.  Rows at or past S come zero-filled.  The pre-pass
//     writes lse log2 e beside D, each head's rows padded to whole tiles so
//     that every box starts aligned, and dK/dV takes a tile's rows of both
//     by one 2-D box with its Q and dO.
//   * A ring of ST stages with a full and an empty mbarrier each: one lane
//     of the producer warpgroup (which gives up its registers with
//     `setmaxnreg`; the consumers take them) keeps the loads of the next
//     tiles in flight while the consumers run their products on the tiles
//     that have landed.  dK/dV: Q, dO, lse and D through the ring, the
//     block's K and V once.  dQ: K and V through the ring, Q and dO once.
//   * The exponential is one `ex2.approx` of s (scale log2 e) - lse log2 e,
//     and the mask is evaluated only on the tiles that cross the diagonal or
//     the end of the sequence.
//   * Causal dQ blocks start from the last q tiles, whose key loops are the
//     longest (dK/dV's first key tiles are already its heaviest).
//
// What is left: each consumer waits for its S/dP products before its
// exponentials and for its dV/dK (dQ) products before the next tile, so a
// warpgroup overlaps nothing of its own (the other warpgroup fills the
// gaps); leaving a product in flight across the next tile's wait, or
// issuing the next tile's S/dP before the exponentials, made ptxas
// serialize every wgmma for want of registers.  dQ is a second pass that
// recomputes S and dP (one deterministic pass would need an ordered
// reduction over the key blocks).  The grid is not persistent.
namespace wgt {

typedef __nv_bfloat16 bf16;
constexpr int T = 64;                      // rows of a tile (one TMA box)
constexpr int NWG = 2;                     // consumer warpgroups a block
constexpr int THREADS = 128 * (NWG + 1);   // and one producer warpgroup
// the consumers' registers once the producer has given up all but 24
constexpr int REGS = 240;
static_assert(NWG * 128 * REGS + 128 * 24 <= 65536, "the register file");
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int TB = T * HD * 2;    // bytes of a 64-row tile
  static constexpr int ST = HD == 64 ? 4 : 3;   // ring stages
  // hd 128: the two warpgroups share the block's 64 keys, one accumulating
  // dV and the other dK (both 64 x 128 accumulators in one warpgroup leave
  // ptxas too few registers: it spills and serializes every wgmma); hd 64:
  // each owns 64 keys and both of their accumulators
  static constexpr bool SPLIT = HD == 128;
  static constexpr int KEYS = SPLIT ? T : NWG * T;   // keys a dK/dV block
  static constexpr int BARS = (1 + 2 * ST) * 8;
  static constexpr int DKDV_SMEM =
      1024 + 2 * KEYS / T * TB + 2 * ST * TB + ST * 2 * T * 4 + BARS;
  static constexpr int DQ_SMEM = 1024 + 2 * NWG * TB + 2 * ST * TB + BARS;
};

// q, k, v and dO, each {hd, H, S, B} with 64 x 1 x 64 x 1 boxes; the
// pre-pass's rows of lse log2 e and D, {B H SP, 2} f32 with 64 x 2 boxes
struct Maps {
  CUtensorMap q, k, v, o, ld;
};

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sa(b)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sa(b))
               : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(sa(b)), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(sa(b)), "r"(parity) : "memory");
}
// this warp is done with a ring stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// the box of `map` at (c0, c1, c2, c3) into dst, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(sa(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(sa(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(sa(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(sa(bar)),
        "r"(c0), "r"(c1) : "memory");
}
// rows r0.. of head h, batch b: a 64-row tile, HD / 64 boxes of 8 KB
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0,
                                          int b) {
#pragma unroll
  for (int a = 0; a < HD / 64; ++a)
    tma_load(dst + a * 8192, map, bar, 64 * a, h, r0, b);
}

// a wgmma shared-memory descriptor under the 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// the k16 step kk of a 64-row tile contracted along its columns (K-major):
// 8-row groups 1024 bytes apart, 32 bytes a step inside a 128-byte atom
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}
// the k16 step kk of a 64-row tile contracted along its rows (MN-major):
// 16 rows of 128 bytes a step, the second 64 columns 8 KB on
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, 8192, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until this warpgroup's committed products have run
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above wg_wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A B^T, A and B K-major in shared memory (descriptors)
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A B, A in registers (bf16 fragments), B MN-major in shared
// memory (the transpose flag of a 16-bit B)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A B, A in registers (bf16 fragments), B MN-major in shared
// memory (the transpose flag of a 16-bit B)
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] (+)= A B^T, A in registers (bf16 fragments), B K-major in
// shared memory
__device__ __forceinline__ void mma_rk_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the A fragments of k16 step kk of a 64-row K-major tile (128-byte
// swizzle) for warp w4's 16 rows, by ldmatrix
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t tile,
                                       int w4, int kk, int lane) {
  const int r = w4 * 16 + (lane & 15), chunk = 2 * (kk & 3) + (lane >> 4);
  const uint32_t addr =
      tile + (kk >> 2) * 8192 + r * 128 + ((chunk ^ (r & 7)) << 4);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

template <int HD>
__device__ __forceinline__ void mma_rs(float (&d)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 64)
    mma_rs_n64(d, a, b);
  else
    mma_rs_n128(d, a, b);
}

// S = A B^T over HD for two 64-row tiles in shared memory, K-major
template <int HD>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_ss_n64(d, desc_k(a, kk), desc_k(b, kk), kk);
}

// D += F B over the 64 rows of a tile B (MN-major): F the four k16
// fragments of a 64 x 64 bf16 operand in registers
template <int HD>
__device__ __forceinline__ void frags_times(float (&d)[HD / 2],
                                            const uint32_t (&f)[4][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<HD>(d, f[kk], desc_mn(b, kk));
}

// P = exp2(S c - lse log2 e) over a thread's fragment of a 64 x 64 score
// tile S (element e of n8 block j at row r0 + 8 (e >> 1), column
// c0 + 8 j + 2 t + (e & 1)), 0 where masked on an `edge` tile, rounded to
// the bf16 A fragments `pf`, and dS = P o (dP - D) to `sf`.  KR (dK/dV):
// the rows are keys and the columns q rows, whose lse log2 e and D are the
// stage's rows L[col] and L[64 + col]; else (dQ) the rows are q rows, with
// lr[e >> 1] and dr[e >> 1], and the columns keys.
template <bool KR, bool P, bool DS>
__device__ __forceinline__ void probs(const float (&sc)[32],
                                      const float (&dp)[32], float c,
                                      const float* L, const float (&lr)[2],
                                      const float (&dr)[2], bool edge,
                                      int r0, int c0, int t, int S,
                                      bool causal, uint32_t (&pf)[4][4],
                                      uint32_t (&sf)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 l2 = {0.f, 0.f}, d2 = {0.f, 0.f};
    if (KR) {
      l2 = *reinterpret_cast<const float2*>(L + 8 * j + 2 * t);
      d2 = *reinterpret_cast<const float2*>(L + T + 8 * j + 2 * t);
    }
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = KR ? ((e & 1) ? l2.y : l2.x) : lr[e >> 1];
      const float d = KR ? ((e & 1) ? d2.y : d2.x) : dr[e >> 1];
      float x = ex2(fmaf(sc[4 * j + e], c, -l));
      if (edge) {
        const int row = r0 + 8 * (e >> 1), col = c0 + 8 * j + 2 * t + (e & 1);
        if (col >= S || (causal && (KR ? row > col : col > row))) x = 0.f;
      }
      p[e] = x;
      ds[e] = x * (dp[4 * j + e] - d);
    }
    if (P) {
      pf[j >> 1][2 * (j & 1)] = pack(p[0], p[1]);
      pf[j >> 1][2 * (j & 1) + 1] = pack(p[2], p[3]);
    }
    if (DS) {
      sf[j >> 1][2 * (j & 1)] = pack(ds[0], ds[1]);
      sf[j >> 1][2 * (j & 1) + 1] = pack(ds[2], ds[3]);
    }
  }
}

// the start of dynamic shared memory rounded up to 1024 bytes, the period
// of the 128-byte swizzle
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (sa(raw) & 1023)) & 1023);
}

// D[(b*H + h)*SP + s] = sum_d dO o O for 16-byte-aligned rows (HD / 8
// lanes a row, 8 values a lane, then a butterfly over the lanes), and
// L2 = lse log2 e beside it, so that the consumers take both by TMA; SP is
// S rounded up to the tile, so that each tile's box starts aligned, and
// the rows from S to SP are zero
template <int HD>
__global__ void __launch_bounds__(256)
dot16(const bf16* __restrict__ dO, const bf16* __restrict__ O,
      const float* __restrict__ lse, float* __restrict__ L2,
      float* __restrict__ D, int S, int SP, int H, Strides sdo, Strides so,
      long long rows) {
  constexpr int L = HD / 8;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  const int c = (threadIdx.x % L) * 8;
  const long long bh = w / SP;
  const int s = (int)(w % SP);
  float acc = 0.f;
  if (w < rows && s < S) {
    const int b = (int)(bh / H), h = (int)(bh % H);
    const uint4 x = *reinterpret_cast<const uint4*>(
        dO + b * sdo.b + s * sdo.s + h * sdo.h + c);
    const uint4 y = *reinterpret_cast<const uint4*>(
        O + b * so.b + s * so.s + h * so.h + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(xp[i]), v = __bfloat1622float2(yp[i]);
      acc = __fmaf_rn(u.x, v.x, acc);
      acc = __fmaf_rn(u.y, v.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (w < rows && threadIdx.x % L == 0) {
    D[w] = acc;
    L2[w] = s < S ? lse[bh * S + s] * LOG2E : 0.f;
  }
}

// dK/dV: a block per (b*h, KEYS keys), 64 q rows a ring stage
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wgmma(const __grid_constant__ Maps maps, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int S, int H, Strides sdk, Strides sdv,
           float scale, int causal) {
  using C = Cfg<HD>;
  constexpr int TB = C::TB, ST = C::ST, NK = C::KEYS / T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Ks = aligned_smem(smem_raw);     // NK tiles
  unsigned char* Vs = Ks + NK * TB;               // NK tiles
  unsigned char* Qs = Vs + NK * TB;               // ST tiles
  unsigned char* Os = Qs + ST * TB;               // ST tiles (dO)
  // [ST][2][T]: each stage's rows of lse log2 e, then of D
  float* LD = reinterpret_cast<float*>(Os + ST * TB);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(LD + ST * 2 * T);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + ST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * C::KEYS;
  const int qt0 = causal ? k0 / T : 0;
  const int nt = (S + T - 1) / T - qt0, SP = (S + T - 1) / T * T;
  if (threadIdx.x == 0) {
    bar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                          // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 4 * NWG && lane == 0) {
      bar_arrive_tx(kv_bar, 2 * NK * TB);
      for (int w = 0; w < NK; ++w) {
        load_tile<HD>(Ks + w * TB, &maps.k, kv_bar, h, k0 + T * w, b);
        load_tile<HD>(Vs + w * TB, &maps.v, kv_bar, h, k0 + T * w, b);
      }
      for (int i = 0; i < nt; ++i) {
        const int s = i % ST, q0 = (qt0 + i) * T;
        bar_wait(empty + s, ((i / ST) & 1) ^ 1);
        bar_arrive_tx(full + s, 2 * TB + 2 * T * 4);
        load_tile<HD>(Qs + s * TB, &maps.q, full + s, h, q0, b);
        load_tile<HD>(Os + s * TB, &maps.o, full + s, h, q0, b);
        tma_load2(LD + s * 2 * T, &maps.ld, full + s, bh * SP + q0, 0);
      }
    }
    return;
  }
  // the consumers: warpgroup w's keys start at kw0 (split: both at k0),
  // a thread's are key0 and key0 + 8; dS^T (dK) is wanted by every
  // warpgroup but, split, warpgroup 0, and P^T (dV) by every one but,
  // split, warpgroup 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
  const int w = warp >> 2, g = lane >> 2, t = lane & 3;
  const int kw0 = C::SPLIT ? k0 : k0 + T * w;
  const int key0 = kw0 + (warp & 3) * 16 + g;
  const bool want_dk = !C::SPLIT || w == 1, want_dv = !C::SPLIT || w == 0;
  const float c = scale * LOG2E;
  const uint32_t kt = sa(Ks + (kw0 - k0) / T * TB);
  const uint32_t vt = sa(Vs + (kw0 - k0) / T * TB);
  float adv[C::SPLIT ? 1 : HD / 2], adk[HD / 2];  // split: adk takes either
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::SPLIT ? 1 : HD / 2); ++i) adv[i] = 0.f;
  bar_wait(kv_bar, 0);
  // hd 64: K and V, fixed for the warpgroup, as A fragments in registers
  constexpr int KF = C::SPLIT ? 1 : HD / 16;
  uint32_t kf[KF][4], vf[KF][4];
  if constexpr (!C::SPLIT) {
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      ldsm_a(kf[kk], kt, warp & 3, kk, lane);
      ldsm_a(vf[kk], vt, warp & 3, kk, lane);
    }
  }
  for (int i = 0; i < nt; ++i) {
    const int s = i % ST, q0 = (qt0 + i) * T;
    bar_wait(full + s, (i / ST) & 1);
    if (!causal || q0 + T - 1 >= kw0) {          // a q row at or below a key
      const uint32_t qs = sa(Qs + s * TB), os = sa(Os + s * TB);
      float st[32], dp[32];                      // S^T, dP^T: 64 keys x 64 q
      wg_fence();
      if constexpr (!C::SPLIT) {
#pragma unroll
        for (int kk = 0; kk < KF; ++kk)
          mma_rk_n64(st, kf[kk], desc_k(qs, kk), kk);
#pragma unroll
        for (int kk = 0; kk < KF; ++kk)
          mma_rk_n64(dp, vf[kk], desc_k(os, kk), kk);
      } else {
        scores<HD>(st, kt, qs);
        if (want_dk) scores<HD>(dp, vt, os);
      }
      wg_commit();
      wg_wait();
      pin(st);
      pin(dp);
      const float* L = LD + s * 2 * T;
      const float none[2] = {0.f, 0.f};
      const bool edge = (causal && q0 < kw0 + T - 1) || q0 + T > S;
      uint32_t pf[4][4], sf[4][4];
      if constexpr (!C::SPLIT) {
        probs<true, true, true>(st, dp, c, L, none, none, edge, key0, q0, t,
                                S, causal, pf, sf);
        wg_fence();
        frags_times<HD>(adv, pf, os);            // dV += P^T dO
        frags_times<HD>(adk, sf, qs);            // dK += dS^T Q
      } else {                      // dS^T (dK) or P^T (dV) into f
        uint32_t(&f)[4][4] = sf;
        if (want_dk)
          probs<true, false, true>(st, dp, c, L, none, none, edge, key0, q0,
                                   t, S, causal, pf, f);
        else
          probs<true, true, false>(st, dp, c, L, none, none, edge, key0, q0,
                                   t, S, causal, f, pf);
        wg_fence();
        frags_times<HD>(adk, f, want_dk ? qs : os);
      }
      wg_commit();
      wg_wait();
      pin(adv);
      pin(adk);
    }
    release(empty + s, lane);
  }
  // store: dK (scaled) from adk, dV from adv, or split the one this
  // warpgroup holds
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const bool is_dk = part == 0;
      if (is_dk ? !want_dk : !want_dv) continue;
      const Strides so = is_dk ? sdk : sdv;
      bf16* o = (is_dk ? dk : dv) + b * so.b + (long long)key * so.s +
                h * so.h + 2 * t;
      const float* acc = (is_dk || C::SPLIT) ? adk : adv;
      const float m = is_dk ? scale : 1.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * m, acc[4 * j + 2 * r + 1] * m);
    }
  }
}

// dQ: a block per (b*h, NWG * 64 q rows), 64 keys a ring stage; under
// causal masking the blocks take their q rows last first
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma(const __grid_constant__ Maps maps, const float* __restrict__ L2,
         const float* __restrict__ D, bf16* __restrict__ dq, int S, int H,
         Strides sdq, float scale, int causal) {
  using C = Cfg<HD>;
  constexpr int TB = C::TB, ST = C::ST;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = aligned_smem(smem_raw);     // NWG tiles
  unsigned char* Os = Qs + NWG * TB;              // NWG tiles (dO)
  unsigned char* Ks = Os + NWG * TB;              // ST tiles
  unsigned char* Vs = Ks + ST * TB;               // ST tiles
  uint64_t* qo_bar = reinterpret_cast<uint64_t*>(Vs + ST * TB);
  uint64_t* full = qo_bar + 1;
  uint64_t* empty = full + ST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int y = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = y * NWG * T;
  const int kend = causal ? min(S, q0 + NWG * T) : S;
  const int nt = (kend + T - 1) / T;
  if (threadIdx.x == 0) {
    bar_init(qo_bar, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                          // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 4 * NWG && lane == 0) {
      bar_arrive_tx(qo_bar, 2 * NWG * TB);
      for (int w = 0; w < NWG; ++w) {
        load_tile<HD>(Qs + w * TB, &maps.q, qo_bar, h, q0 + T * w, b);
        load_tile<HD>(Os + w * TB, &maps.o, qo_bar, h, q0 + T * w, b);
      }
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        bar_wait(empty + s, ((j / ST) & 1) ^ 1);
        bar_arrive_tx(full + s, 2 * TB);
        load_tile<HD>(Ks + s * TB, &maps.k, full + s, h, j * T, b);
        load_tile<HD>(Vs + s * TB, &maps.v, full + s, h, j * T, b);
      }
    }
    return;
  }
  // the consumers: warpgroup w's rows start at qw0, a thread's are row0
  // and row0 + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
  const int w = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + T * w;
  const int row0 = qw0 + (warp & 3) * 16 + g;
  const float c = scale * LOG2E;
  const int SP = (S + T - 1) / T * T;
  float lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * SP + row0 + 8 * r;
    lr[r] = row0 + 8 * r < S ? L2[i] : 0.f;
    Dr[r] = row0 + 8 * r < S ? D[i] : 0.f;
  }
  const uint32_t qt = sa(Qs + w * TB), ot = sa(Os + w * TB);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  bar_wait(qo_bar, 0);
  // Q and dO, fixed for the block, as A fragments in registers
  uint32_t qf[HD / 16][4], of[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm_a(qf[kk], qt, warp & 3, kk, lane);
    ldsm_a(of[kk], ot, warp & 3, kk, lane);
  }
  for (int j = 0; j < nt; ++j) {
    const int s = j % ST, kt0 = j * T;
    bar_wait(full + s, (j / ST) & 1);
    if (!causal || kt0 <= qw0 + T - 1) {         // a key at or left of a row
      const uint32_t ks = sa(Ks + s * TB), vs = sa(Vs + s * TB);
      float sc[32], dp[32];                      // S, dP: 64 rows x 64 keys
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_rk_n64(sc, qf[kk], desc_k(ks, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_rk_n64(dp, of[kk], desc_k(vs, kk), kk);
      wg_commit();
      wg_wait();
      pin(sc);
      pin(dp);
      const bool edge = (causal && kt0 + T - 1 > qw0) || kt0 + T > S;
      uint32_t sf[4][4];
      probs<false, false, true>(sc, dp, c, nullptr, lr, Dr, edge, row0, kt0,
                                t, S, causal, sf, sf);
      wg_fence();
      frags_times<HD>(acc, sf, ks);              // dQ += dS K
      wg_commit();
      wg_wait();
      pin(acc);
    }
    release(empty + s, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* out = dq + b * sdq.b + (long long)row * sdq.s + h * sdq.h + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no link against the driver
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// p: dims[4] (elements, innermost first), strides[3] (bytes), box[4]
int encode(CUtensorMap* map, const void* base, const long long* p) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return 1003;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], one[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)p[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)p[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)p[7 + i];
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1002;
}

// the {np, 2} f32 rows of lse log2 e and D, in boxes of 64 x 2
int encode_rows(CUtensorMap* map, const float* base, long long np) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return 1003;
  const cuuint64_t dims[2] = {(cuuint64_t)np, 2};
  const cuuint64_t stride[1] = {(cuuint64_t)np * 4};
  const cuuint32_t box[2] = {T, 2}, one[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, stride, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1002;
}

template <int HD>
int launch(const void* const* ins, const bf16* o, const float* lse, float* D,
           bf16* dq, bf16* dk, bf16* dv, int B, int S, int H,
           const Strides* st, const long long* map_args, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<HD>;
  // ins: q, k, v, dO; map_args: their maps, 11 values each
  Maps maps;
  CUtensorMap* m[4] = {&maps.q, &maps.k, &maps.v, &maps.o};
  for (int i = 0; i < 4; ++i) {
    const int e = encode(m[i], ins[i], map_args + 11 * i);
    if (e != 0) return e;
  }
  // D: the scratch of 2 np floats, lse log2 e then D, np = B H SP with SP
  // = S rounded up to the tile
  const int SP = (S + T - 1) / T * T;
  const long long np = (long long)B * H * SP;
  {
    const int e = encode_rows(&maps.ld, D, np);
    if (e != 0) return e;
  }
  const bf16* dO = static_cast<const bf16*>(ins[3]);
  dot16<HD><<<(unsigned)((np * (HD / 8) + 255) / 256), 256, 0, stream>>>(
      dO, o, lse, D, D + np, S, SP, H, st[4], st[3], np);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kv = dkdv_wgmma<HD>;
  e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DKDV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(B * H, (S + C::KEYS - 1) / C::KEYS), THREADS, C::DKDV_SMEM,
       stream>>>(maps, dk, dv, S, H, st[6], st[7], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kq = dq_wgmma<HD>;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3(B * H, (S + NWG * T - 1) / (NWG * T)), THREADS, C::DQ_SMEM,
       stream>>>(maps, D, D + np, dq, S, H, st[5], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgt

bool aligned(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

template <typename T>
int launch_hd(int hd, int bk, const void* q, const void* k, const void* v,
              const void* o, const void* dO, const float* lse, float* D,
              void* dq, void* dk, void* dv, int B, int S, int H,
              const Strides* st, float scale, int causal, cudaStream_t s) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dO);
  T *tdq = static_cast<T*>(dq), *tdk = static_cast<T*>(dk), *tdv = static_cast<T*>(dv);
  if (hd == 64 && bk == 64)
    return launch<T, 64, 64>(tq, tk, tv, to, tdo, lse, D, tdq, tdk, tdv, B, S, H, st, scale, causal, s);
  if (hd == 128 && bk == 32)
    return launch<T, 128, 32>(tq, tk, tv, to, tdo, lse, D, tdq, tdk, tdv, B, S, H, st, scale, causal, s);
  return 1001;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv).
// variant (from `flash_attention_bwd.plan`): 0 = fma_f32 (f32), 2 =
// hmma_guarded, 3 = wgmma_tma (bf16).  bq, bk: the plan's tiles (fma: bk
// keys a dK/dV block, 64 at hd 64 and 32 at hd 128; hmma: bq q rows a dK/dV
// step and bk keys a dQ step, 64 at hd 64 and 32 at hd 128; wgmma: 64 and
// 64, the rows of a ring stage).  strides: 24 int64 values, the (batch,
// seq, head) strides in elements of q, k, v, out, dout, dq, dk and dv.
// maps (wgmma_tma only, else unused): 44 int64 values, the tensor maps of
// q, k, v and dout, each dims[4] (hd, H, S, B), byte strides[3] (head, seq,
// batch) and box[4].  lse: (B, H, S) f32 from the forward.  D: f32
// scratch, written here: B H S values, or for wgmma_tma 2 B H SP (lse
// log2 e, then D; SP = S rounded up to a multiple of 64).  Returns the
// cudaError_t of the launches (0 on success); 1000 for an unknown type or
// variant, 1001 for tiles the kernel does not take or wgmma_tma on an
// operand that is not 16-byte aligned, 1002 when a tensor map does not
// encode, 1003 when the driver has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_bwd_launch(
    int dtype, int variant, int bq, int bk, const void* q, const void* k,
    const void* v, const void* o, const void* dO, const void* lse, void* D,
    void* dq, void* dk, void* dv, int B, int S, int H, int hd,
    const long long* strides, const long long* maps, float scale, int causal,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  if (variant == 0) {
    if (dtype != 0) return 1000;
    if (bq != 64) return 1001;
    return launch_hd<float>(hd, bk, q, k, v, o, dO, l, d, dq, dk, dv, B, S, H, st, scale, causal, s);
  }
  if (dtype != 1 || (variant != 2 && variant != 3)) return 1000;
  typedef __nv_bfloat16 bf16;
  const bf16 *bq_ = static_cast<const bf16*>(q), *bk_ = static_cast<const bf16*>(k),
             *bv_ = static_cast<const bf16*>(v), *bo_ = static_cast<const bf16*>(o),
             *bdo = static_cast<const bf16*>(dO);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  if (variant == 3) {
    const void* p[8] = {q, k, v, o, dO, dq, dk, dv};
    for (int i = 0; i < 8; ++i)
      if (!aligned(p[i], st[i])) return 1001;
    if (bq != 64 || bk != 64) return 1001;
    const void* ins[4] = {q, k, v, dO};
    if (hd == 64)
      return wgt::launch<64>(ins, bo_, l, d, gq, gk, gv, B, S, H, st, maps, scale, causal, s);
    if (hd == 128)
      return wgt::launch<128>(ins, bo_, l, d, gq, gk, gv, B, S, H, st, maps, scale, causal, s);
    return 1001;
  }
  if (hd == 64 && bq == 64 && bk == 64)
    return hmma::launch<64, 64, 64>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
  if (hd == 128 && bq == 32 && bk == 32)
    return hmma::launch<128, 32, 32>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
  return 1001;
}
