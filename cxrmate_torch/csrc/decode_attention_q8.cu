// Decode attention over an int8-quantised K/V cache: M query rows (1 for
// greedy, the beam count for beam search's shared cross cache) against S keys
// stored as int8 rows with one fp32 scale per key, and a [B, S] fp32 additive
// key mask, for one decode step.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:310
// decode_attention_rowgroup_q8 (Pallas, TPU; kernel body :282-306), fed by
// quantize_kv_rowwise (:259, plain tensor ops in both packages).
// Contract: scores = (q . kq) in fp32, x ks[s], then x scale, + mask; softmax
// with the row max subtracted, in fp32, NOT rounded; pv = probs x vs[s],
// rounded to q's dtype (the V scale is folded in before the one rounding);
// ctx = pv . vq accumulated in fp32 and cast to q's dtype. The int8 values are
// never multiplied by their scales: both scales fold into the [M, S] tensors,
// and int8 -> fp32 is exact. A fully masked row (mask = finfo(f32).min, not
// -inf) gives the uniform softmax.
//
// Bound on the H100: bytes. The cross-attention step streams 2 * H * S * dh
// int8 values and 2 * H * S fp32 scales per study per layer: 68 bytes per key
// and head for K, against 128 in bf16 (53%).
//
// Design: decode_attention.cu's three passes, one block of 256 threads per
// (b, h). An int8 key row is 64 bytes: four lanes read it with one 16-byte
// load each, so a warp load covers eight rows and the block 64; four loads
// per lane are in flight. Pass 1 converts in registers, accumulates q . kq in
// fp32 and writes the M x S scores to shared memory; pass 2 takes the exact
// (not online) softmax, needed because pv is rounded after the V scale is
// folded into the finished probs; pass 3 streams vq once for all M rows and
// reduces the per-warp partial contexts through shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // key-row loads in flight per lane
constexpr int kDh = 64;              // head dim = bytes of one int8 key row
constexpr int kVpr = 16;             // int8 values per 16-byte vector
constexpr int kLpk = kDh / kVpr;     // 4 lanes per key row
constexpr int kKpw = 32 / kLpk;      // 8 key rows per warp load
constexpr int kStep = kWarps * kKpw; // 64 key rows per block load

// Unpack one 16-byte vector of int8 into 16 floats (exact).
__device__ __forceinline__ void unpack_i8(const uint4& v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<signed char>((w[i] >> (8 * j)) & 0xffu));
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
decode_attn_q8_kernel(const T* __restrict__ q, const signed char* __restrict__ kq,
                      const float* __restrict__ ks, const signed char* __restrict__ vq,
                      const float* __restrict__ vs, const float* __restrict__ mask,
                      T* __restrict__ o, int heads, int m, int s_len, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [m][kDh]
  float* sc = qs + m * kDh;      // [m][s_len] scores, then pv
  float* part = sc + m * s_len;  // [kWarps][m][kDh] partial contexts
  __shared__ float red[kWarps];

  const int bh = blockIdx.x, b = bh / heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kLpk;  // key row within the warp's load
  const int li = lane % kLpk;   // 16-byte vector within the key row
  const T* qb = q + (size_t)bh * m * kDh;
  const uint4* k4 = reinterpret_cast<const uint4*>(kq + (size_t)bh * s_len * kDh);
  const uint4* v4 = reinterpret_cast<const uint4*>(vq + (size_t)bh * s_len * kDh);
  const float* ksb = ks + (size_t)bh * s_len;  // scales are [B, H, 1, S]
  const float* vsb = vs + (size_t)bh * s_len;
  const float* mb = mask + (size_t)b * s_len;

  for (int i = tid; i < m * kDh; i += kThreads) qs[i] = cxr::to_float(qb[i]);
  __syncthreads();

  // pass 1: scores
  {
    float qf[MM][kVpr];
#pragma unroll
    for (int r = 0; r < MM; ++r)
#pragma unroll
      for (int e = 0; e < kVpr; ++e) qf[r][e] = r < m ? qs[r * kDh + li * kVpr + e] : 0.f;
    for (int s0 = warp * kKpw; s0 < s_len; s0 += kStep * kUnroll) {
      uint4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kStep + sub;
        buf[u] = s < s_len ? __ldg(k4 + (size_t)s * kLpk + li) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kStep + sub;
        float kf[kVpr];
        unpack_i8(buf[u], kf);
        float acc[MM];
#pragma unroll
        for (int r = 0; r < MM; ++r) {
          acc[r] = 0.f;
#pragma unroll
          for (int e = 0; e < kVpr; ++e) acc[r] = fmaf(qf[r][e], kf[e], acc[r]);
#pragma unroll
          for (int off = kLpk / 2; off > 0; off >>= 1)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (li == 0 && s < s_len) {
          const float kscale = ksb[s], mk = mb[s];
#pragma unroll
          for (int r = 0; r < MM; ++r)
            if (r < m) sc[r * s_len + s] = (acc[r] * kscale) * scale + mk;
        }
      }
    }
  }
  __syncthreads();

  // pass 2: exact softmax per row (fp32, not rounded); pv = probs x vs,
  // rounded to T
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
      row[i] = cxr::to_float(cxr::from_float<T>((row[i] / sum) * vsb[i]));
  }
  __syncthreads();

  // pass 3: context = pv . vq
  float cacc[MM][kVpr];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < kVpr; ++e) cacc[r][e] = 0.f;
  for (int s0 = warp * kKpw; s0 < s_len; s0 += kStep * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      buf[u] = s < s_len ? __ldg(v4 + (size_t)s * kLpk + li) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      if (s < s_len) {
        float vf[kVpr];
        unpack_i8(buf[u], vf);
#pragma unroll
        for (int r = 0; r < MM; ++r) {
          const float p = r < m ? sc[r * s_len + s] : 0.f;
#pragma unroll
          for (int e = 0; e < kVpr; ++e) cacc[r][e] = fmaf(p, vf[e], cacc[r][e]);
        }
      }
    }
  }
  // reduce over the warp's key rows (lanes with the same li), then over warps
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < kVpr; ++e)
#pragma unroll
      for (int off = kLpk; off < 32; off <<= 1)
        cacc[r][e] += __shfl_xor_sync(0xffffffffu, cacc[r][e], off);
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m)
#pragma unroll
        for (int e = 0; e < kVpr; ++e) part[(warp * m + r) * kDh + li * kVpr + e] = cacc[r][e];
  }
  __syncthreads();
  T* ob = o + (size_t)bh * m * kDh;
  for (int i = tid; i < m * kDh; i += kThreads) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += part[w * m * kDh + i];
    ob[i] = cxr::from_float<T>(x);
  }
}

template <typename T, int MM>
cudaError_t launch_mm(const void* q, const void* kq, const void* ks, const void* vq,
                      const void* vs, const void* mask, void* o, int bh, int heads, int m,
                      int s_len, float scale, size_t smem, cudaStream_t stream) {
  auto fn = decode_attn_q8_kernel<T, MM>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const signed char*>(kq),
      static_cast<const float*>(ks), static_cast<const signed char*>(vq),
      static_cast<const float*>(vs), static_cast<const float*>(mask), static_cast<T*>(o),
      heads, m, s_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                   const void* mask, void* o, int bh, int heads, int m, int s_len, int dh,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)m * dh + (size_t)m * s_len + (size_t)kWarps * m * dh);
  if (dh != kDh || m < 1 || m > 4) return cudaErrorInvalidValue;
  if (m == 1)
    return launch_mm<T, 1>(q, kq, ks, vq, vs, mask, o, bh, heads, m, s_len, scale, smem, stream);
  return launch_mm<T, 4>(q, kq, ks, vq, vs, mask, o, bh, heads, m, s_len, scale, smem, stream);
}

}  // namespace

extern "C" int cxr_decode_attention_q8_f32(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* mask,
                                           void* o, int bh, int heads, int m, int s_len, int dh,
                                           float scale, void* stream) {
  return launch<float>(q, kq, ks, vq, vs, mask, o, bh, heads, m, s_len, dh, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_q8_bf16(const void* q, const void* kq, const void* ks,
                                            const void* vq, const void* vs, const void* mask,
                                            void* o, int bh, int heads, int m, int s_len, int dh,
                                            float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kq, ks, vq, vs, mask, o, bh, heads, m, s_len, dh, scale,
                               static_cast<cudaStream_t>(stream));
}
