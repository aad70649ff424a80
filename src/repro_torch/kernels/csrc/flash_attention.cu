// Flash attention (online softmax) for Hopper (sm_90a):
//     out[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h, :] * hd^-0.5) v[b, t, h, :]
// with an element-level causal mask (t <= s) when asked.
//
// Replaces `repro/kernels/flash_attention.py:flash_attention_pallas` (body
// `_flash_kernel`).  As there: f32 running max m, denominator l and
// accumulator; p rounded to v's type before the PV product; masked scores
// set to -1e30; out = acc / max(l, 1e-30) rounded to q's type.  q, k, v and
// out are read and written in the public (B, S, H, hd) layout through their
// strides (the last axis contiguous), so no transposed copy is made.
// f32 and bf16, hd in {64, 128}, same H for q, k and v.
//
// What bounds it.  4 * B * H * S^2 * hd operations (half of them, plus the
// diagonal, when causal) against q, k, v read once and out written once: at
// S = 4096, hd = 128 that is 1000+ operations per byte, far above the ridge
// (295 in bf16 on the tensor cores, 20 in f32), so it is bound by operations.
//
// Design.  The TPU kernel's grid is (B*H, S/bq, S/bk) with the KV axis
// sequential and (m, l, acc) carried in VMEM scratch across it.  Here one
// block of 4 warps owns one (b, h, 64-row q tile) and a loop inside it walks
// the 64-row KV tiles -- blocks run in parallel and in no order, so nothing is
// carried between them.  The q tile and each K/V tile are staged in shared
// memory as f32 (K and Q rows padded by one word, so that the lanes reading
// eight rows at one column hit eight banks); with the P tile that is 66 KB
// (hd = 64) or 113 KB (hd = 128), above the 48 KB static limit, so it is
// dynamic and the launch raises the kernel's limit first.  Each warp owns 16
// q rows; lane (rg, cg) holds 4 rows x 8 keys of the score tile and 4 rows x
// hd/8 columns of the accumulator in registers, m and l per row replicated on
// the 8 lanes of its row group, and the row max and sum reduced by shuffles
// inside the group.  p goes through shared memory (rounded to v's type) to
// the PV product.  KV tiles wholly above the diagonal are not visited; the
// diagonal tile is masked per element.  Products run on the FMA units in
// f32, one fixed order per output: no atomics, reproducible.  Left to later
// work: tensor cores (mma.sync / wgmma) for both products, TMA loads into a
// ring of K/V stages, and bf16 tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;
constexpr int LDP = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// p rounded to v's type and back, as `p.astype(v.dtype)` in the TPU kernel
__device__ __forceinline__ float round_as(float v, float) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Strides {
  long long b, s, h;      // in elements; the hd axis is contiguous
};

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)BQ * (HD + 1) + (size_t)BK * (HD + 1) + (size_t)BK * HD +
         (size_t)BQ * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             Strides sq, Strides sk, Strides sv, Strides so, float scale,
             int causal) {
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
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kern = flash_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, sq, sk, sv, so,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64 values, (batch, seq,
// head) strides in elements of q, k, v and out.  Returns the cudaError_t of
// the launch (0 on success); 1000 for an unknown dtype or head dim.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int hd, const long long* strides,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, strides, scale, causal, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, strides, scale, causal, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, strides, scale, causal, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, strides, scale, causal, s);
  return 1000;
}
