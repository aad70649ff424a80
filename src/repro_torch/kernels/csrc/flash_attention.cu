// Flash attention (online softmax) for Hopper (sm_90a):
//     out[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h, :] * hd^-0.5) v[b, t, h, :]
// with an element-level causal mask (t <= s) when asked.
//
// Replaces `repro/kernels/flash_attention.py:flash_attention_pallas` (body
// `_flash_kernel`).  As there: f32 running max m, denominator l and
// accumulator; p rounded to v's type before the PV product; masked scores
// set to -1e30; out = acc / max(l, 1e-30) rounded to q's type.  q, k, v and
// out are read and written in the public (B, S, H, hd) layout through their
// strides (the last axis contiguous), so no transposed copy is made.  Same H
// for q, k and v; hd in {64, 128}.  `flash_attention.plan` (Python) picks the
// variant and passes it in:
//
//   bf16, `hmma_cpasync` / `hmma_guarded` -- FlashAttention-2 on the tensor
//     cores.  One block of 4 warps per (b*h, 64-row q tile); each warp owns
//     16 q rows.  Q is loaded once into registers as mma A fragments (ldmatrix
//     from a bf16 shared tile).  K and V stay bf16 in shared memory, in a ring
//     of 2 stages of 64-key tiles filled by 16-byte cp.async copies (keys past
//     S zero-filled), so tile j+1 lands while tile j is multiplied; rows are
//     padded by 16 bytes so each ldmatrix phase hits 8 distinct bank groups.
//     S = Q K^T on `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, K
//     rows [t][d] read as the "col" B operand by ldmatrix (no .trans).  The
//     online softmax runs on the f32 S fragments (lane l holds rows l/4 and
//     l/4 + 8, keys 2(l%4), 2(l%4)+1 of each 8-key tile; row max and sum over
//     the 4 lanes of a row by __shfl_xor_sync 1, 2), in base 2 (the scale
//     folded with log2(e), one exp2 per score).  l sums the unrounded p; the
//     S fragments, rounded to bf16 pairs, are the A fragments of P V
//     straight from registers -- that rounding is the TPU kernel's
//     `p.astype(v.dtype)` -- and V comes through ldmatrix.trans.  Wherever a
//     base pointer or a (batch, seq, head) stride is not 16-byte aligned the
//     plan picks `hmma_guarded`: the same kernel with element loads.
//     Registers hold Q (hd/16 x 4), the accumulator (hd/8 x 4 f32) and one
//     S tile (32 f32); shared memory is 87 KB (hd 128) or 46 KB (hd 64), so
//     two blocks share an SM at hd = 128.  64-row tiles rather than 128: at
//     equal warps per SM the two blocks' barriers overlap, and the causal
//     tail is finer; each K/V tile is read by 4 warps instead of 8.
//   f32, `fma_f32` -- the FMA-unit kernel below, unchanged: TF32 would keep
//     about three digits, against the f32 tolerance of 1e-4 * max|plain|.
//
// Causal: KV tiles wholly above the q tile are not loaded, a warp skips a
// tile wholly above its own 16 rows (exact: it would add 0 and scale by 1),
// and the diagonal and ragged tiles are masked per element.  The hmma grid is
// (B*H, q tiles) with the q tile reversed on causal runs, so the heaviest
// tiles of every head launch first and the light tail fills in behind them.
//
// What bounds it.  4 * B * H * S^2 * hd operations (half of them, plus the
// diagonal, when causal) against q, k, v read once and out written once: at
// S = 4096, hd = 128 that is 1000+ operations per byte, far above the ridge
// (295 in bf16 on the tensor cores, 20 in f32), so it is bound by operations
// -- on this route by mma.sync's HMMA rate, below the 989 TFLOP/s that
// only wgmma reaches -- and by the softmax between the two products.  Each output is summed in one fixed order (no atomics, no
// split over keys): the result does not depend on B or H and is bitwise
// reproducible.  Left to later work: wgmma with TMA-fed K/V stages and a
// producer warp.
//
// Checked on the card by `chip_smoke.py` (HMMA in every tensor-core
// instance, counted with `cuobjdump -sass` on the built library; ptxas
// registers and spills per instance) and by
// `PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`,
// run in the same chip call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;      // in elements; the hd axis is contiguous
};

// ---- f32: the FMA-unit kernel ---------------------------------------------
//
// One block of 4 warps owns one (b, h, 64-row q tile) and a loop inside it
// walks the 64-row KV tiles.  The q tile and each K/V tile are staged in
// shared memory as f32 (K and Q rows padded by one word, so that the lanes
// reading eight rows at one column hit eight banks); with the P tile that is
// 66 KB (hd = 64) or 113 KB (hd = 128), dynamic, the kernel's limit raised
// first.  Each warp owns 16 q rows; lane (rg, cg) holds 4 rows x 8 keys of
// the score tile and 4 rows x hd/8 columns of the accumulator in registers,
// m and l per row replicated on the 8 lanes of its row group, the row max
// and sum reduced by shuffles inside the group.  p goes through shared
// memory to the PV product.
namespace fma {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;
constexpr int LDP = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
// p rounded to v's type and back, as `p.astype(v.dtype)` in the TPU kernel
__device__ __forceinline__ float round_as(float v, float) { return v; }

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
         (size_t)BQ * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int S, int H, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, int causal) {
  constexpr int LDQ = HD + 1;
  constexpr int DJ = HD / 8;                 // accumulator columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;                 // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;                 // [BK][HD]
  float* Ps = Vs + BK * HD;                  // [BQ][LDP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = lane >> 3;                  // row group: 4 rows
  const int cg = lane & 7;                   // key / column group
  const int r0 = warp * 16 + rg * 4;         // first of this lane's rows
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    const int s = q0 + r;
    Qs[r * LDQ + c] = s < S ? to_f(qb[s * sq.s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();                         // the previous K/V tile is read
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, c = idx % HD;
      const int t = k0 + r;
      Ks[r * LDQ + c] = t < S ? to_f(kb[t * sk.s + c]) : 0.f;
      Vs[r * HD + c] = t < S ? to_f(vb[t * sv.s + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows r0..r0+3, keys cg + 8j
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r0 + i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(cg + 8 * j) * LDQ + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = __fmaf_rn(qv[i], kv[j], sc[i][j]);
    }

    // online softmax, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sr = q0 + r0 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = k0 + cg + 8 * j;
        float s = sc[i][j] * scale;
        if (t >= S || (causal && t > sr)) s = NEG;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        Ps[(r0 + i) * LDP + cg + 8 * j] = round_as(p, T());
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                            // P rows are this warp's own

    // acc += P V: rows r0..r0+3, columns cg + 8j
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r0 + i) * LDP + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[t * HD + cg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
    __syncwarp();                            // P is read before it is rewritten
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sr = q0 + r0 + i;
    if (sr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) from_f(ob + sr * so.s + cg + 8 * j, acc[i][j] / den);
    if (lse != nullptr && cg == 0) lse[(long long)bh * S + sr] = m[i] + logf(den);
  }
}


template <int HD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int H, const Strides* st, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kern = flash_kernel<float, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(q, k, v, o, lse, S, H, st[0], st[1],
                                   st[2], st[3], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma

// ---- bf16: FlashAttention-2 on mma.sync -----------------------------------
namespace hmma {

typedef __nv_bfloat16 bf16;
constexpr int BQ = 64;             // q rows per block: 4 warps x 16
constexpr int BKV = 64;            // keys per K/V tile
constexpr int NT = 2 * BQ;
constexpr float NEG = -1e30f;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;          // padded row, in bf16
  static constexpr int Q = BQ * LD;
  static constexpr int KV = BKV * LD;        // one K or one V tile
  // q tile + 2 stages x (K, V)
  static constexpr size_t bytes = (size_t)(Q + 4 * KV) * sizeof(bf16);
};

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
// two f32 rounded to a bf16 pair, the lower column in the low half
__device__ __forceinline__ unsigned pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ROWS rows of HD values, row r read at src + (r0 + r) * stride, into
// dst[r][LD]; rows at or past S are zero-filled (so P V never meets garbage)
template <int HD, bool ASYNC, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int r0, int S,
                                          int tid) {
  constexpr int LD = Layout<HD>::LD;
  if (ASYNC) {
    constexpr int CPR = HD / 8;              // 16-byte chunks per row
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

template <int HD, bool ASYNC>
__global__ void __launch_bounds__(NT)
flash_hmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int S, int H, Strides sq,
                  Strides sk, Strides sv, Strides so, float scale,
                  int causal) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int KD = HD / 16;                // k16 steps of Q K^T
  constexpr int DT = HD / 8;                 // 8-wide tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + L::Q;                     // stage s: K, then V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int w0 = q0 + warp * 16;             // this warp's first row
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  bf16* ob = o + b * so.b + h * so.h;

  const int kend = causal ? min(S, q0 + BQ) : S;
  const int nkv = (kend + BKV - 1) / BKV;
  const float scale_log2 = scale * 1.4426950408889634f;
  auto load_kv = [&](int j, int st) {
    bf16* Ks = KVs + 2 * st * L::KV;
    load_tile<HD, ASYNC, BKV>(Ks, kb, sk.s, j * BKV, S, tid);
    load_tile<HD, ASYNC, BKV>(Ks + L::KV, vb, sv.s, j * BKV, S, tid);
  };
  load_tile<HD, ASYNC, BQ>(Qs, qb, sq.s, q0, S, tid);
  load_kv(0, 0);
  cp_async_commit();
  if (nkv > 1) load_kv(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  unsigned qf[KD][4];                        // Q as A fragments, all of hd
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // rows g and g + 8

  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BKV;
    const bf16* Ks = KVs + 2 * (j & 1) * L::KV;
    const bf16* Vs = Ks + L::KV;
    if (!causal || k0 <= w0 + 15) {
      float s[8][4];                         // 16 rows x 64 keys
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          unsigned kf[4];
          ldsm_x4(kf, Ks + (jj * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                          kd * 16 + ((lane >> 3) & 1) * 8);
          mma(s[2 * jj], qf[kd], kf);
          mma(s[2 * jj + 1], qf[kd], kf + 2);
        }

      // online softmax on the f32 fragments, in base 2: x = s * scale *
      // log2(e), so exp(s*scale - m) is one ex2 of x - m2
      const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > w0);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            const int row = w0 + g + 8 * (e >> 1);
            if (key >= S || (causal && key > row)) x = NEG;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];

      // acc += P V: the S fragments of keys 16kt..16kt+15, rounded to bf16
      // pairs, are the A fragment; V [t][d] through ldmatrix.trans
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const unsigned pa[4] = {pack(s[2 * kt][0], s[2 * kt][1]),
                                pack(s[2 * kt][2], s[2 * kt][3]),
                                pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                                pack(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
        for (int dd = 0; dd < DT / 2; ++dd) {
          unsigned vf[4];
          ldsm_x4_trans(vf, Vs + (kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                dd * 16 + (lane >> 4) * 8);
          mma(acc[2 * dd], pa, vf);
          mma(acc[2 * dd + 1], pa, vf + 2);
        }
      }
    }
    __syncthreads();                         // every warp is done with stage j&1
    if (j + 2 < nkv) load_kv(j + 2, j & 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile j+1 has landed
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (long long)row * so.s + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * r] / den, acc[d][2 * r + 1] / den);
    // m is in base-2 units of the scaled score: lse = (m + log2 l) ln 2
    if (lse != nullptr && t == 0)
      lse[(long long)bh * S + row] = (m[r] + log2f(den)) * 0.6931471805599453f;
  }
}

template <int HD, bool ASYNC>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int B, int S, int H, const Strides* st, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  auto kern = flash_hmma_kernel<HD, ASYNC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(q, k, v, o, lse, S, H, st[0], st[1],
                                   st[2], st[3], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.s % 8 == 0 && s.h % 8 == 0;
}

}  // namespace hmma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant (from `flash_attention.plan`):
// 0 = fma_f32, 1 = hmma_cpasync, 2 = hmma_guarded.  strides: 12 int64
// values, (batch, seq, head) strides in elements of q, k, v and out.
// Returns the cudaError_t of the launch (0 on success); 1000 for a dtype,
// head dim or variant that does not go together, 1001 for hmma_cpasync on
// an operand that is not 16-byte aligned.
extern "C" int flash_attention_launch(int dtype, int variant, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int S, int H, int hd,
                                      const long long* strides, float scale,
                                      int causal, void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  float* fl = static_cast<float*>(lse);
  if (dtype == 0 && variant == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(o);
    if (hd == 64) return fma::launch<64>(fq, fk, fv, fo, fl, B, S, H, st, scale, causal, s);
    if (hd == 128) return fma::launch<128>(fq, fk, fv, fo, fl, B, S, H, st, scale, causal, s);
    return 1000;
  }
  if (dtype != 1 || (variant != 1 && variant != 2)) return 1000;
  using hmma::bf16;
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  bf16* bo = static_cast<bf16*>(o);
  if (variant == 1) {
    if (!(hmma::aligned(q, st[0]) && hmma::aligned(k, st[1]) &&
          hmma::aligned(v, st[2])))
      return 1001;
    if (hd == 64) return hmma::launch<64, true>(bq, bk, bv, bo, fl, B, S, H, st, scale, causal, s);
    if (hd == 128) return hmma::launch<128, true>(bq, bk, bv, bo, fl, B, S, H, st, scale, causal, s);
    return 1000;
  }
  if (hd == 64) return hmma::launch<64, false>(bq, bk, bv, bo, fl, B, S, H, st, scale, causal, s);
  if (hd == 128) return hmma::launch<128, false>(bq, bk, bv, bo, fl, B, S, H, st, scale, causal, s);
  return 1000;
}
