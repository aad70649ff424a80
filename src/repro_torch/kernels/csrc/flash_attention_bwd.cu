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
//   3. dQ: one block per (b*h, 64-row q tile), looping over the key tiles
//      up to the diagonal: the same S, dP and dS, and dQ += dS K, scaled
//      once at the end.
//
// Two routes, chosen by `flash_attention_bwd.plan`: bf16 on the tensor cores
// (`hmma_cpasync` / `hmma_guarded`, namespace `hmma` below), f32 on the FMA
// units (`fma_f32`, the kernels right below: TF32 would keep about three
// digits).  dq, dk, dv are rounded once to the input type;
// `kernels/ref.py:flash_attention_bwd_ref` is the same arithmetic in plain
// PyTorch.
//
// What bounds it.  Five products of 2 * pairs * hd operations per (b, h)
// (pairs = S^2, or S (S + 1) / 2 causal; S and dP are computed twice, in the
// dK/dV and the dQ kernel: seven done) against q, k, v, out, dO read and
// dq, dk, dv written once: far above the ridge, so bound by operations --
// on the bf16 route by mma.sync's HMMA rate, below the 989 TFLOP/s that
// only wgmma reaches, and by the exponentials between the products.  Left
// to later work: wgmma with TMA-fed stages and one pass for dQ.
//
// The f32 FMA kernel.  Tiles: 64 q rows by BK keys, BK = 64 at hd 64 and 32
// at hd 128, 128 threads; Q, dO, K and V tiles in shared memory as f32 rows
// padded by one word (lanes reading eight rows at one column hit eight
// banks), P and dS tiles likewise, 100 KB (hd 64) or 116 KB (hd 128)
// dynamic.  Each thread owns 4 rows x BK/8 keys of the score tiles and
// 4 x 8 of the dK/dV (or 4 x hd/8 of the dQ) accumulators.

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


// ---- bf16: the products on mma.sync ----------------------------------------
//
// `hmma_cpasync` / `hmma_guarded`: the same three steps with every product on
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, as the forward's
// tensor-core kernel.  dK/dV: a block of 4 warps owns 64 keys, each warp 16,
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
// 16-byte cp.async when every base address and stride is 16-byte aligned
// (`hmma_cpasync`), else by element loads (`hmma_guarded`); rows at or
// past S are zero.
namespace hmma {

typedef __nv_bfloat16 bf16;
constexpr int NT = 128;            // 4 warps

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}
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
template <int HD, bool ASYNC, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int S,
                                          int tid) {
  constexpr int LD = HD + 8;
  if (ASYNC) {
    constexpr int CPR = HD / 8;
    static_assert(ROWS * CPR % NT == 0, "chunks split evenly");
#pragma unroll
    for (int c = tid; c < ROWS * CPR; c += NT) {
      const int r = c / CPR, d = (c % CPR) * 8;
      const bool ok = r0 + r < S;
      cp_async16(dst + r * LD + d, src + (ok ? (long long)(r0 + r) * stride : 0) + d, ok);
    }
  } else {
    for (int e = tid; e < ROWS * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      dst[r * LD + d] = r0 + r < S ? src[(long long)(r0 + r) * stride + d]
                                   : __float2bfloat16(0.f);
    }
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
template <int HD, int BQ, bool ASYNC>
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

  load_tile<HD, ASYNC, BK>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S, tid);
  load_tile<HD, ASYNC, BK>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S, tid);

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;

  for (int q0 = causal ? (k0 / BQ) * BQ : 0; q0 < S; q0 += BQ) {
    __syncthreads();                             // the previous tiles are read
    load_tile<HD, ASYNC, BQ>(Qs, qb, sq.s, q0, S, tid);
    load_tile<HD, ASYNC, BQ>(Os, ob, sdo.s, q0, S, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < S;
      ls[tid] = in ? lb[q0 + tid] : 0.f;
      Ds[tid] = in ? Db[q0 + tid] : 0.f;
    }
    if (ASYNC) cp_async_wait_all();
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
template <int HD, int BK, bool ASYNC>
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

  load_tile<HD, ASYNC, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<HD, ASYNC, BQ>(Os, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
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
    load_tile<HD, ASYNC, BK>(Ks, kb, sk.s, kt0, S, tid);
    load_tile<HD, ASYNC, BK>(Vs, vb, sv.s, kt0, S, tid);
    if (ASYNC) cp_async_wait_all();
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

template <int HD, int BQ, int BK, bool ASYNC>
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
  auto kv = dkdv_kernel<HD, BQ, ASYNC>;
  const size_t s1 = sizeof(bf16) * (size_t)(2 * 64 + 2 * BQ) * LD +
                    sizeof(float) * 2 * BQ;
  e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv<<<dim3(B * H, (S + 63) / 64), NT, s1, stream>>>(
      q, k, v, dO, lse, D, dk, dv, S, H, st[0], st[1], st[2], st[4], st[6],
      st[7], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kq = dq_kernel<HD, BK, ASYNC>;
  const size_t s2 = sizeof(bf16) * (size_t)(2 * 64 + 2 * BK) * LD;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  kq<<<dim3(B * H, (S + 63) / 64), NT, s2, stream>>>(
      q, k, v, dO, lse, D, dq, S, H, st[0], st[1], st[2], st[4], st[5], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

}  // namespace hmma

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
// variant (from `flash_attention_bwd.plan`): 0 = fma_f32 (f32), 1 =
// hmma_cpasync, 2 = hmma_guarded (bf16).  bq, bk: the plan's tiles (fma: bk
// keys a dK/dV block, 64 at hd 64 and 32 at hd 128; hmma: bq q rows a dK/dV
// step and bk keys a dQ step, 64 at hd 64 and 32 at hd 128).  strides: 24
// int64 values, the (batch, seq, head) strides in elements of q, k, v, out,
// dout, dq, dk and dv.  lse: (B, H, S) f32 from the forward; D: (B, H, S)
// f32 scratch, written here.  Returns the cudaError_t of the launches (0 on
// success); 1000 for an unknown type or variant, 1001 for tiles the kernel
// does not take or hmma_cpasync on an operand that is not 16-byte aligned.
extern "C" int flash_attention_bwd_launch(
    int dtype, int variant, int bq, int bk, const void* q, const void* k,
    const void* v, const void* o, const void* dO, const void* lse, void* D,
    void* dq, void* dk, void* dv, int B, int S, int H, int hd,
    const long long* strides, float scale, int causal, void* stream) {
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
  if (dtype != 1 || (variant != 1 && variant != 2)) return 1000;
  using hmma::bf16;
  const bf16 *bq_ = static_cast<const bf16*>(q), *bk_ = static_cast<const bf16*>(k),
             *bv_ = static_cast<const bf16*>(v), *bo_ = static_cast<const bf16*>(o),
             *bdo = static_cast<const bf16*>(dO);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  if (variant == 1) {
    for (int i = 0; i < 8; ++i) {
      const void* p[8] = {q, k, v, o, dO, dq, dk, dv};
      if (!hmma::aligned(p[i], st[i])) return 1001;
    }
    if (hd == 64 && bq == 64 && bk == 64)
      return hmma::launch<64, 64, 64, true>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
    if (hd == 128 && bq == 32 && bk == 32)
      return hmma::launch<128, 32, 32, true>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
    return 1001;
  }
  if (hd == 64 && bq == 64 && bk == 64)
    return hmma::launch<64, 64, 64, false>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
  if (hd == 128 && bq == 32 && bk == 32)
    return hmma::launch<128, 32, 32, false>(bq_, bk_, bv_, bo_, bdo, l, d, gq, gk, gv, B, S, H, st, scale, causal, s);
  return 1001;
}
