// Device code shared by the four kernels of the fused decoder-layer step
// (fused_qkv_attn.cu, fused_out_ln_q.cu, fused_cross_attn.cu,
// fused_out_ln_ffn.cu), which replace the four Pallas bodies of
// cxrmate_tpu/ops/fused_decode.py:366 fused_layer_step_v2, and by the one
// kernel of v1 (fused_layer_step.cu, :164 fused_layer_step).
//
// Three building blocks, all fp32 inside (weights and activations are cast up
// from their storage type, as the Pallas bodies do with .astype(float32)):
//
//   dense_pass   y[b, o] = sum_i x[b, i] W[o, i] for up to kRows batch rows at
//                once. W is nn.Linear's [out, in]: one output's weights are
//                contiguous, so a warp takes one output, its lanes read the
//                row with 16-byte loads side by side, and every weight is read
//                once for all rows. The rows of x sit in shared memory in a
//                layout (xs_pos) that lets the lanes read them without bank
//                conflicts. The warps of the whole grid share the outputs.
//   layer_norm_rows  fp32 LayerNorm (biased variance) of rows that an earlier
//                dense pass left in device memory, into shared memory for the
//                next pass: one pass over device memory, the statistics from
//                shared memory. Every block normalises every row itself:
//                8 x 768 values, cheaper than another grid-wide sync.
//   attend       one (study, head): a 64-wide query against cached K/V rows
//                under an integer key mask, optionally with one extra key (the
//                step's own token). Exact softmax over scores in shared
//                memory; the probabilities are NOT rounded before P.V (the
//                Pallas bodies keep them fp32, unlike decode_attention).
//
// Masked scores are s + finfo(f32).min, which is finfo(f32).min itself for any
// |s| < 2^103: a masked key has probability exactly 0 unless every key of the
// row is masked, and then every score is the same and the softmax is uniform.
// attend uses both facts: it never loads a masked key's K row, loads a V row
// only where the probability is not 0, and in the all-masked case runs over
// every column so that the row gets what the plain version gives it.
//
// The LayerNorm sits between two products, and a product needs the whole
// normalised row. The dense kernels are launched cooperatively (one block per
// SM) and put a grid-wide sync between the stages, so that every stage uses
// the whole card and every weight comes from device memory once; a stage's
// result crosses the sync through an fp32 scratch buffer, read past L1
// (__ldcg) because another SM wrote it.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cxr {
namespace fused {

constexpr float kNeg = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int kRows = 8;    // batch rows one dense pass carries per weight read
constexpr int kDh = 64;     // head dim
constexpr int kUnroll = 4;  // 16-byte loads in flight per lane

// Where element i of an n-wide fp32 row lives in shared memory. A lane of a
// dense pass owns 16 bytes of weights = VPR elements. fp32 (VPR 4): in place.
// bf16 (VPR 8): the lane's first four elements go to the first half-row, its
// last four to the second, so that each of its two float4 reads is next to its
// neighbour lane's.
template <typename T> __device__ __forceinline__ int xs_pos(int i, int n);
template <> __device__ __forceinline__ int xs_pos<float>(int i, int n) { return i; }
template <> __device__ __forceinline__ int xs_pos<__nv_bfloat16>(int i, int n) {
  return ((i >> 2) & 1) * (n >> 1) + ((i >> 3) << 2) + (i & 3);
}

// The VPR elements of lane-vector j of a row in that layout.
template <typename T> __device__ __forceinline__ void load_x(const float* row, int j, int n, float* x);
template <> __device__ __forceinline__ void load_x<float>(const float* row, int j, int n, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * j);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
template <> __device__ __forceinline__ void load_x<__nv_bfloat16>(const float* row, int j, int n,
                                                                 float* x) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * j);
  const float4 b = *reinterpret_cast<const float4*>(row + (n >> 1) + 4 * j);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The store type O of layer_norm_rows and attend defaults to the storage
// type T (v2's kernels round there); the v1 step names float to keep its
// intermediates unrounded. Never deduced, so a bare nullptr still passes.
template <typename X> struct store_t { using type = X; };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Four consecutive elements of a read-only vector of T (aligned to four
// elements) as floats, in one load.
__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Store the VPR elements of lane-vector j of a row in that layout.
template <typename T> __device__ __forceinline__ void store_x(float* row, int j, int n, const float* x);
template <> __device__ __forceinline__ void store_x<float>(float* row, int j, int n, const float* x) {
  *reinterpret_cast<float4*>(row + 4 * j) = make_float4(x[0], x[1], x[2], x[3]);
}
template <> __device__ __forceinline__ void store_x<__nv_bfloat16>(float* row, int j, int n,
                                                                  const float* x) {
  *reinterpret_cast<float4*>(row + 4 * j) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + (n >> 1) + 4 * j) = make_float4(x[4], x[5], x[6], x[7]);
}

struct Nothing {
  __device__ __forceinline__ void operator()() const {}
};

// Rows [0, rows) of a contiguous [rows, n] array of T in device memory -> xs
// (dense-pass layout, fp32); rows [rows, kRows) are zeroed. 16-byte loads,
// kUnroll of them in flight per thread; issued() once a thread's first loads
// are on their way (at once if it has none). The caller syncs the block.
template <typename T, typename Issued = Nothing>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int rows, int n, float* xs,
                                          Issued issued = Issued()) {
  constexpr int VPR = 16 / sizeof(T);
  const int nvec = n / VPR, total = kRows * nvec, live = rows * nvec;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  bool first = true;
  for (int i0 = threadIdx.x; i0 < total; i0 += blockDim.x * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      buf[u] = i < live ? __ldg(s4 + i) : make_uint4(0, 0, 0, 0);
    }
    if (first) issued();
    first = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int r = i / nvec;
        float x[VPR];
        unpack16<T>(buf[u], x);
        store_x<T>(xs + r * n, i - r * nvec, n, x);
      }
    }
  }
  if (first) issued();
}

// The same for fp32 rows another block wrote during this launch. A group of
// four floats stays together in either layout.
template <typename T>
__device__ __forceinline__ void load_scratch_rows(const float* src, int rows, int n, float* xs) {
  const int nq = n / 4, total = kRows * nq, live = rows * nq;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i0 = threadIdx.x; i0 < total; i0 += blockDim.x * kUnroll) {
    float4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      buf[u] = i < live ? __ldcg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < total) {
        const int r = i / nq;
        *reinterpret_cast<float4*>(xs + r * n + xs_pos<T>(4 * (i - r * nq), n)) = buf[u];
      }
    }
  }
}

// Sum each of the kRows = 8 values over the warp with 9 shuffles instead of
// 40: at each of the first three steps a lane hands half of its values to its
// partner and keeps the sums of the other half. Afterwards the lanes with
// (lane & 3) == 0 hold the total of value lane >> 2.
__device__ __forceinline__ float warp_sum_rows(const float* acc, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a4[4], a2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float got = __shfl_xor_sync(0xffffffffu, h16 ? acc[k] : acc[k + 4], 16);
    a4[k] = (h16 ? acc[k + 4] : acc[k]) + got;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float got = __shfl_xor_sync(0xffffffffu, h8 ? a4[k] : a4[k + 2], 8);
    a2[k] = (h8 ? a4[k + 2] : a4[k]) + got;
  }
  float a = (h4 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, h4 ? a2[0] : a2[1], 4);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  return a;
}

// y[b, o] = sum_i x[b, i] w[o, i] for the kRows rows in xs and the outputs
// o = gwarp, gwarp + gwarps, ... . The lane that will hold row b's sum (lane
// 4 b) first calls pre(o, b) for the two addends of its result (bias,
// residual), so that their loads are under way while the weights stream, and
// at the end epi(o, b, y[b, o], addends) if b < rows. The next kUnroll weight
// vectors are loaded before the current ones are used, and the rows go four
// at a time (their shared-memory reads first, then four independent chains of
// multiply-adds): a pass keeps few warps busy per SM, so a warp has to hide
// its own latencies. n_in is a multiple of 16 / sizeof(T), w 16-byte aligned.
template <typename T, typename Pre, typename Epi>
__device__ __forceinline__ void dense_pass(const float* xs, int n_in, const T* __restrict__ w,
                                           int n_out, int rows, int gwarp, int gwarps, Pre pre,
                                           Epi epi) {
  constexpr int VPR = 16 / sizeof(T);
  constexpr int HALF = kRows / 2;
  const int lane = threadIdx.x & 31;
  const int nvec = n_in / VPR;
  const int my_row = lane >> 2;
  const bool writer = (lane & 3) == 0 && my_row < rows;
  for (int o = gwarp; o < n_out; o += gwarps) {
    const uint4* w4 = reinterpret_cast<const uint4*>(w + (size_t)o * n_in);
    const float2 add = writer ? pre(o, my_row) : make_float2(0.f, 0.f);
    uint4 cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = lane + 32 * u;
      cur[u] = j < nvec ? __ldg(w4 + j) : make_uint4(0, 0, 0, 0);
    }
    float acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = 0.f;
    for (int j0 = lane; j0 < nvec; j0 += 32 * kUnroll) {
      uint4 nxt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 32 * (kUnroll + u);
        nxt[u] = j < nvec ? __ldg(w4 + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 32 * u;
        if (j < nvec) {
          float wf[VPR];
          unpack16<T>(cur[u], wf);
#pragma unroll
          for (int b0 = 0; b0 < kRows; b0 += HALF) {
            float xf[HALF][VPR];
#pragma unroll
            for (int b = 0; b < HALF; ++b) load_x<T>(xs + (b0 + b) * n_in, j, n_in, xf[b]);
#pragma unroll
            for (int e = 0; e < VPR; ++e)
#pragma unroll
              for (int b = 0; b < HALF; ++b) acc[b0 + b] = fmaf(xf[b][e], wf[e], acc[b0 + b]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }
    const float y = warp_sum_rows(acc, lane);
    if (writer) epi(o, my_row, y, add);
  }
}

// fp32 LayerNorm over the last axis of rows [0, rows) of y ([rows, n] fp32 in
// device memory, written by other blocks during this launch): mean, biased
// variance, (y - mean) / sqrt(var + eps) * gamma + beta. One warp per row: it
// copies the row into xs (dense-pass layout) in one pass over device memory
// (16-byte loads, kUnroll in flight per lane), takes the statistics from
// there and normalises in place. Rows up to kRows are zeroed. If out is not
// null the result also goes there ([rows, n]), stored as O (rounded when O is
// T = bf16). The caller syncs the block.
template <typename T, int NW, typename O = T>
__device__ __forceinline__ void layer_norm_rows(const float* y, int rows, int n,
                                                const T* __restrict__ gamma,
                                                const T* __restrict__ beta, float eps, float* xs,
                                                typename store_t<O>::type* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = n / 4;
  for (int r = warp; r < kRows; r += NW) {
    float* xr = xs + r * n;
    if (r >= rows) {
      for (int i = lane; i < n; i += 32) xr[i] = 0.f;
      continue;
    }
    const float4* y4 = reinterpret_cast<const float4*>(y + (size_t)r * n);
    float s = 0.f;
    for (int c0 = lane; c0 < nq; c0 += 32 * kUnroll) {
      float4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        buf[u] = c < nq ? __ldcg(y4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < nq) {
          *reinterpret_cast<float4*>(xr + xs_pos<T>(4 * c, n)) = buf[u];
          s += (buf[u].x + buf[u].y) + (buf[u].z + buf[u].w);
        }
      }
    }
    const float mean = warp_sum(s) / (float)n;
    float q = 0.f;
    for (int c = lane; c < nq; c += 32) {  // each lane rereads what it wrote
      const float4 v = *reinterpret_cast<const float4*>(xr + xs_pos<T>(4 * c, n));
      const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
      q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)n + eps);
    for (int c0 = lane; c0 < nq; c0 += 32 * kUnroll) {
      float g[kUnroll][4], be[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < nq) {
          load4(gamma + 4 * c, g[u]);
          load4(beta + 4 * c, be[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + 32 * u;
        if (c < nq) {
          float4* at = reinterpret_cast<float4*>(xr + xs_pos<T>(4 * c, n));
          const float4 v = *at;
          float4 z;
          z.x = (v.x - mean) * rstd * g[u][0] + be[u][0];
          z.y = (v.y - mean) * rstd * g[u][1] + be[u][1];
          z.z = (v.z - mean) * rstd * g[u][2] + be[u][2];
          z.w = (v.w - mean) * rstd * g[u][3] + be[u][3];
          *at = z;
          if (out != nullptr) {
            O* o = out + (size_t)r * n + 4 * c;
            o[0] = from_float<O>(z.x);
            o[1] = from_float<O>(z.y);
            o[2] = from_float<O>(z.z);
            o[3] = from_float<O>(z.w);
          }
        }
      }
    }
  }
}

// Shared memory (floats) attend needs besides the query: scores for n_all
// cached keys and the extra one, and the per-warp partial contexts.
__host__ __device__ inline size_t attend_floats(int n_all, int warps) {
  return (size_t)((n_all + 1 + 3) / 4) * 4 + (size_t)warps * kDh;
}

// One (study, head). qs: the query, 64 fp32 in shared memory, unscaled. kc/vc:
// the cached [n_all, 64] K and V rows of T. mask: the study's n_all integers,
// non-zero = may be attended; only columns below `limit` count. With has_new,
// one more key (kn, vn: 64 fp32 each in shared memory) is scored after the
// cached ones, open iff new_ok. sc holds attend_floats(n_all, NW) floats, red
// NW floats. Writes the 64 context values, as O, to out. Every thread
// of the block calls it; it ends with a block-wide sync.
template <typename T, int NW, typename O = T>
__device__ __forceinline__ void attend(const float* qs, const T* kc, const T* vc, const int* mask,
                                       int n_all, int limit, bool has_new, const float* kn,
                                       const float* vn, bool new_ok, float scale, float* sc,
                                       float* red, typename store_t<O>::type* out) {
  constexpr int VPR = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int LPK = kDh / VPR;       // lanes per key row
  constexpr int KPW = 32 / LPK;        // key rows one warp load covers
  constexpr int STEP = NW * KPW;       // key rows the block covers per load
  constexpr int THREADS = NW * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPK;  // key row within the warp's load
  const int li = lane % LPK;   // 16-byte vector within the key row
  float* part = sc + ((n_all + 1 + 3) / 4) * 4;  // [NW][kDh]
  const uint4* k4 = reinterpret_cast<const uint4*>(kc);
  const uint4* v4 = reinterpret_cast<const uint4*>(vc);

  int open = 0;
  for (int i = tid; i < limit; i += THREADS) open |= (mask[i] != 0);
  open = __syncthreads_or(open);
  // every key masked: all scores are finfo.min, the softmax is uniform over
  // all n_all (+ 1) columns, whatever they hold
  const bool dark = !(open || (has_new && new_ok));
  const int n = dark ? n_all : limit;

  float qf[VPR];
#pragma unroll
  for (int e = 0; e < VPR; ++e) qf[e] = qs[li * VPR + e];

  // pass 1: scores of the cached keys
  for (int s0 = warp * KPW; s0 < n; s0 += STEP * kUnroll) {
    uint4 buf[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      ok[u] = s < limit && mask[s] != 0;
      buf[u] = ok[u] ? k4[(size_t)s * LPK + li] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      float kf[VPR];
      unpack16<T>(buf[u], kf);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < VPR; ++e) acc = fmaf(qf[e], kf[e], acc);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (li == 0 && s < n) sc[s] = ok[u] ? acc * scale : kNeg;
    }
  }
  // the step's own token, scored from its unrounded fp32 key
  if (has_new && warp == 0) {
    float a = fmaf(qs[lane], kn[lane], qs[lane + 32] * kn[lane + 32]);
    a = warp_sum(a);
    if (lane == 0) sc[n] = new_ok ? a * scale : kNeg;
  }
  __syncthreads();

  // pass 2: exact softmax, fp32, not rounded
  const int cnt = n + (has_new ? 1 : 0);
  float mx = -INFINITY;
  for (int i = tid; i < cnt; i += THREADS) mx = fmaxf(mx, sc[i]);
  mx = block_max<NW>(mx, red);
  float sum = 0.f;
  for (int i = tid; i < cnt; i += THREADS) {
    const float e = expf(sc[i] - mx);
    sc[i] = e;
    sum += e;
  }
  sum = block_sum<NW>(sum, red);
  for (int i = tid; i < cnt; i += THREADS) sc[i] = sc[i] / sum;
  __syncthreads();

  // pass 3: context = probs . V over the keys with a non-zero probability
  float cacc[VPR];
#pragma unroll
  for (int e = 0; e < VPR; ++e) cacc[e] = 0.f;
  for (int s0 = warp * KPW; s0 < n; s0 += STEP * kUnroll) {
    uint4 buf[kUnroll];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      p[u] = s < n ? sc[s] : 0.f;
      buf[u] = p[u] != 0.f ? v4[(size_t)s * LPK + li] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[VPR];
      unpack16<T>(buf[u], vf);
#pragma unroll
      for (int e = 0; e < VPR; ++e) cacc[e] = fmaf(p[u], vf[e], cacc[e]);
    }
  }
  // reduce over the warp's key rows (lanes with the same li), then over warps
#pragma unroll
  for (int e = 0; e < VPR; ++e)
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      cacc[e] += __shfl_xor_sync(0xffffffffu, cacc[e], off);
  if (sub == 0) {
#pragma unroll
    for (int e = 0; e < VPR; ++e) part[warp * kDh + li * VPR + e] = cacc[e];
  }
  __syncthreads();
  for (int i = tid; i < kDh; i += THREADS) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += part[w * kDh + i];
    if (has_new) x = fmaf(sc[n], vn[i], x);
    out[i] = from_float<O>(x);
  }
  __syncthreads();
}

// The split-K pass of the dense kernels that use it (fused_qkv_attn.cu,
// fused_out_ln_ffn.cu): a unit is one output's K-slice of kSliceVecs 16-byte
// weight vectors (512 bytes), one vector a lane, multiplied with the lane's
// input values of up to kRows rows from shared memory and summed over the
// warp; the units of a block are cut into contiguous runs, one a warp, and a
// warp has the weights of up to kBatch units in flight. The number of
// K-slices is a function of the input width and the dtype alone, and an
// output's slices are added in slice order, so a row's bits depend neither on
// the card, the grid nor the batch. The kernels that use it launch blocks of
// kPassThreads threads.
constexpr int kPassThreads = 512;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kSliceVecs = 32;   // 16-byte weight vectors of a K-slice: one a lane
constexpr int kBatch = 3;        // units whose weights a warp has in flight, unless a kernel says
constexpr size_t kPiece = 16384; // bytes of one L2 prefetch

// K-slices of a split pass with n_in inputs of T (ops/fused_decode.py:pass_slices)
template <typename T> __device__ __forceinline__ int slices(int n_in) {
  return (n_in / (16 / (int)sizeof(T)) + kSliceVecs - 1) / kSliceVecs;
}

__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"((unsigned)bytes)
               : "memory");
}

// Bring the n values of T at p into this SM's L1, a 128-byte line a thread:
// the LayerNorms' vectors, asked for before the grid sync that precedes them.
template <typename T>
__device__ __forceinline__ void prefetch_l1(const T* p, int n) {
  const char* c = reinterpret_cast<const char*>(p);
  for (int at = threadIdx.x * 128; at < n * (int)sizeof(T); at += kPassThreads * 128)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(c + at));
}

// Ask L2 for [p, p + bytes), in pieces spread over the block's threads.
__device__ __forceinline__ void prefetch_range(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t at = threadIdx.x * kPiece; at < bytes; at += kPassThreads * kPiece)
    prefetch_l2(c + at, bytes - at < kPiece ? bytes - at : kPiece);
}

// The units [ub, ue) of a pass over w ([n_out, n_in], T) and the input rows
// in xs (dense-pass layout, kRows rows of n_in): unit u is K-slice u / n_o of
// output o_lo + u % n_o. The block's warps take contiguous runs of units, as
// even as can be (warp w [ub + (ue - ub) w / 16, ub + (ue - ub) (w + 1) / 16));
// a warp loads the weights of up to NB units at once, lane j the slice's
// vector j, multiplies them with the rows' values from shared memory in fp32
// (each row's products in a fixed order, four rows at a time) and adds the
// lanes by warp_sum_rows; sink(u, o, k, row, partial) at lane 4 row, for
// row < rows.
template <typename T, int NB = kBatch, typename Sink>
__device__ __forceinline__ void split_pass(const float* xs, int n_in, const T* __restrict__ w,
                                           int o_lo, int n_o, int ub, int ue, int rows,
                                           Sink sink) {
  constexpr int VPR = 16 / sizeof(T);
  constexpr int HALF = kRows / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = n_in / VPR;
  const int first = ub + (ue - ub) * warp / kPassWarps;
  const int last = ub + (ue - ub) * (warp + 1) / kPassWarps;
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  for (int u0 = first; u0 < last; u0 += NB) {
    uint4 wv[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = u0 + i, k = u / n_o, j = k * kSliceVecs + lane;
      wv[i] = u < last && j < nvec ? __ldg(w4 + (size_t)(o_lo + u - k * n_o) * nvec + j)
                                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = u0 + i;
      if (u >= last) break;
      const int k = u / n_o, j = k * kSliceVecs + lane;
      float wf[VPR];
      unpack16<T>(wv[i], wf);
      float acc[kRows];
#pragma unroll
      for (int b0 = 0; b0 < kRows; b0 += HALF) {
        float xf[HALF][VPR];
#pragma unroll
        for (int b = 0; b < HALF; ++b) {
          if (j < nvec) {
            load_x<T>(xs + (b0 + b) * n_in, j, n_in, xf[b]);
          } else {
#pragma unroll
            for (int e = 0; e < VPR; ++e) xf[b][e] = 0.f;
          }
        }
#pragma unroll
        for (int b = 0; b < HALF; ++b) {
          acc[b0 + b] = xf[b][0] * wf[0];
#pragma unroll
          for (int e = 1; e < VPR; ++e) acc[b0 + b] = fmaf(xf[b][e], wf[e], acc[b0 + b]);
        }
      }
      const float y = warp_sum_rows(acc, lane);
      if ((lane & 3) == 0 && (lane >> 2) < rows) sink(u, o_lo + u - k * n_o, k, lane >> 2, y);
    }
  }
}

// The block's outputs [lo, hi) of a pass, in rounds of at most `cap`: their
// units' partials into part ([slice][output][kRows]), then each (output,
// row) the sum of its slices' partials in slice order, to epi(o, row, y,
// pre(o, row)); a thread's first pre() is loaded before the pass.
template <typename T, int NB = kBatch, typename Pre, typename Epi>
__device__ __forceinline__ void block_outputs(const float* xs, int n_in, const T* __restrict__ w,
                                              int lo, int hi, int rows, float* part, int cap,
                                              Pre pre, Epi epi) {
  const int ks = slices<T>(n_in);
  for (int o0 = lo; o0 < hi; o0 += cap) {
    const int n_o = min(cap, hi - o0);
    const int p0 = threadIdx.x, i0 = p0 / rows;
    const float2 add0 = p0 < n_o * rows ? pre(o0 + i0, p0 - i0 * rows) : make_float2(0.f, 0.f);
    split_pass<T, NB>(xs, n_in, w, o0, n_o, 0, ks * n_o, rows,
                  [&](int u, int, int, int row, float y) { part[u * kRows + row] = y; });
    __syncthreads();
    for (int p = p0; p < n_o * rows; p += kPassThreads) {
      const int i = p / rows, row = p - i * rows;
      float y = part[i * kRows + row];
      for (int k = 1; k < ks; ++k) y += part[(k * n_o + i) * kRows + row];
      epi(o0 + i, row, y, p == p0 ? add0 : pre(o0 + i, row));
    }
    __syncthreads();
  }
}

// One block per SM for a cooperative launch of `fn`, or an error if not even
// one block of it fits. Sets the dynamic shared memory limit (always: 48 KB of
// dynamic memory and the kernel's static memory together exceed the default).
inline cudaError_t cooperative_grid(const void* fn, int threads, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *grid = sms;
  return cudaSuccess;
}

}  // namespace fused
}  // namespace cxr
