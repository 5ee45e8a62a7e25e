// Decode attention: M query rows (1 for greedy, the beam count for beam
// search's shared cross cache) against a cached K/V of S keys with a [B, S]
// fp32 additive key mask, for one decode step.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:50 decode_attention (Pallas,
// TPU) and its blockings :98 decode_attention_rowgrid and :149
// decode_attention_rowgroup, which compute the same function.
// Contract (decode_attention.py:31-46, HF eager order): scores = q.k in fp32,
// x scale, + mask; softmax with the row max subtracted, in fp32; the probs are
// rounded to the input dtype before P.V; the context accumulates in fp32 and
// is cast to the input dtype. A fully masked row (mask = finfo(f32).min, not
// -inf) gives the uniform softmax, as the plain path does.
//
// Bound on the H100: bytes. The cross-attention step streams 2 * H * S * dh
// elements per study per layer (8.85 MB in bf16 at S = 2,880) for 4 * M * S * dh
// flops; self-attention streams the [T, dh] self cache the same way.
//
// Design: one block of 256 threads per (b, h). K and V rows (dh = 64, the
// only head dim the path has) are read with 16-byte vector loads, LPK lanes
// per key row, four rows per lane in flight. M is 1 or up to 4 (the beams).
// Pass 1 writes the M x S scores to shared memory; pass 2 turns each row into
// the exact (not online) softmax so that the probs can be rounded to the input
// dtype as the contract asks; pass 3 streams V once for all M rows and reduces
// the per-warp partial contexts through shared memory. Splitting S over more
// blocks is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // key-row loads in flight per lane
constexpr int kDh = 64;     // head dim

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ mask, T* __restrict__ o, int heads, int m,
                   int s_len, float scale) {
  constexpr int VPR = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int DH = kDh;
  constexpr int LPK = DH / VPR;        // lanes per key row
  constexpr int KPW = 32 / LPK;        // key rows one warp load covers
  constexpr int STEP = kWarps * KPW;   // key rows the block covers per load

  extern __shared__ float smem[];
  float* qs = smem;            // [m][DH]
  float* sc = qs + m * DH;     // [m][s_len] scores, then probs
  float* part = sc + m * s_len;  // [kWarps][m][DH] partial contexts
  __shared__ float red[kWarps];

  const int bh = blockIdx.x, b = bh / heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPK;  // key row within the warp's load
  const int li = lane % LPK;   // 16-byte vector within the key row
  const T* qb = q + (size_t)bh * m * DH;
  const uint4* k4 = reinterpret_cast<const uint4*>(k + (size_t)bh * s_len * DH);
  const uint4* v4 = reinterpret_cast<const uint4*>(v + (size_t)bh * s_len * DH);
  const float* mb = mask + (size_t)b * s_len;

  for (int i = tid; i < m * DH; i += kThreads) qs[i] = cxr::to_float(qb[i]);
  __syncthreads();
  float qf[MM][VPR];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < VPR; ++e) qf[r][e] = r < m ? qs[r * DH + li * VPR + e] : 0.f;

  // pass 1: scores
  for (int s0 = warp * KPW; s0 < s_len; s0 += STEP * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      buf[u] = s < s_len ? __ldg(k4 + (size_t)s * LPK + li) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      float kf[VPR];
      cxr::unpack16<T>(buf[u], kf);
      float acc[MM];
#pragma unroll
      for (int r = 0; r < MM; ++r) {
        acc[r] = 0.f;
#pragma unroll
        for (int e = 0; e < VPR; ++e) acc[r] = fmaf(qf[r][e], kf[e], acc[r]);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (li == 0 && s < s_len) {
#pragma unroll
        for (int r = 0; r < MM; ++r)
          if (r < m) sc[r * s_len + s] = acc[r] * scale + mb[s];
      }
    }
  }
  __syncthreads();

  // pass 2: exact softmax per row; probs rounded to T
  for (int r = 0; r < m; ++r) {
    float* row = sc + r * s_len;
    float mx = -INFINITY;
    for (int i = tid; i < s_len; i += kThreads) mx = fmaxf(mx, row[i]);
    mx = cxr::block_max<kWarps>(mx, red);
    float sum = 0.f;
    for (int i = tid; i < s_len; i += kThreads) {
      const float e = expf(row[i] - mx);
      row[i] = e;
      sum += e;
    }
    sum = cxr::block_sum<kWarps>(sum, red);
    for (int i = tid; i < s_len; i += kThreads)
      row[i] = cxr::to_float(cxr::from_float<T>(row[i] / sum));
  }
  __syncthreads();

  // pass 3: context = probs . V
  float cacc[MM][VPR];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < VPR; ++e) cacc[r][e] = 0.f;
  for (int s0 = warp * KPW; s0 < s_len; s0 += STEP * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      buf[u] = s < s_len ? __ldg(v4 + (size_t)s * LPK + li) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * STEP + sub;
      if (s < s_len) {
        float vf[VPR];
        cxr::unpack16<T>(buf[u], vf);
#pragma unroll
        for (int r = 0; r < MM; ++r) {
          const float p = r < m ? sc[r * s_len + s] : 0.f;
#pragma unroll
          for (int e = 0; e < VPR; ++e) cacc[r][e] = fmaf(p, vf[e], cacc[r][e]);
        }
      }
    }
  }
  // reduce over the warp's key rows (lanes with the same li), then over warps
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < VPR; ++e)
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1)
        cacc[r][e] += __shfl_xor_sync(0xffffffffu, cacc[r][e], off);
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m)
#pragma unroll
        for (int e = 0; e < VPR; ++e) part[(warp * m + r) * DH + li * VPR + e] = cacc[r][e];
  }
  __syncthreads();
  T* ob = o + (size_t)bh * m * DH;
  for (int i = tid; i < m * DH; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += part[w * m * DH + i];
    ob[i] = cxr::from_float<T>(x);
  }
}

template <typename T, int MM>
cudaError_t launch_mm(const void* q, const void* k, const void* v, const float* mask, void* o,
                      int bh, int heads, int m, int s_len, float scale, size_t smem,
                      cudaStream_t stream) {
  auto fn = decode_attn_kernel<T, MM>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<bh, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), mask, static_cast<T*>(o),
                                     heads, m, s_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   int bh, int heads, int m, int s_len, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)m * dh + (size_t)m * s_len + (size_t)kWarps * m * dh);
  const float* mk = static_cast<const float*>(mask);
  if (dh != kDh || m < 1 || m > 4) return cudaErrorInvalidValue;
  if (m == 1) return launch_mm<T, 1>(q, k, v, mk, o, bh, heads, m, s_len, scale, smem, stream);
  return launch_mm<T, 4>(q, k, v, mk, o, bh, heads, m, s_len, scale, smem, stream);
}

}  // namespace

extern "C" int cxr_decode_attention_f32(const void* q, const void* k, const void* v,
                                        const void* mask, void* o, int bh, int heads, int m,
                                        int s_len, int dh, float scale, void* stream) {
  return launch<float>(q, k, v, mask, o, bh, heads, m, s_len, dh, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* mask, void* o, int bh, int heads, int m,
                                         int s_len, int dh, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, o, bh, heads, m, s_len, dh, scale,
                               static_cast<cudaStream_t>(stream));
}
