// Decode attention from separate fp32 multiplies and adds in one fixed order.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:221
// decode_attention_rowgroup_vpu (Pallas, TPU; kernel body :189-217): the
// contract of decode_attention (decode_attention.cu) with q, K and V cast to
// fp32 and every contraction an unfused multiply followed by a reduction, no
// matrix unit. On the TPU it probed whether a kernel could reproduce the
// reduction order of the compiler's own attention bit for bit.
//
// What makes this a different kernel from decode_attention.cu is its
// arithmetic. Every product is __fmul_rn and every sum __fadd_rn (the
// intrinsics are never contracted into an fma, whatever the compiler flags),
// and the order of every sum is a function of (S, dh) alone:
//
//   score[s]  the 64 products k[s][d] * q[d] are summed as 16 runs of four
//             consecutive d, each left to right ((p0 + p1) + p2) + p3, and
//             the 16 runs by a balanced binary tree over neighbours
//             (run 2i + run 2i+1, then pairs of those, ...); then
//             score = (sum * scale) + mask[s].
//   softmax   max over s (order-free); e[s] = expf(score[s] - max); the
//             denominator sums e over the 256 strided streams s = t, t + 256,
//             ... (each in increasing s), the 32 streams of a warp by a
//             balanced tree over neighbours, the 8 warps left to right;
//             p[s] = e[s] / denominator (__fdiv_rn), rounded to the input
//             dtype.
//   ctx[d]    the products p[s] * v[s][d] are summed over the 16 strided
//             streams s = j, j + 16, ... (each in increasing s, from 0.0f),
//             streams 2w and 2w + 1 are added, and the 8 results w = 0..7
//             left to right.
//
// The launch never changes that order: one block of 256 threads per (b, h)
// whatever B and M, 16 lanes per key row in both dtypes (four elements a
// lane: a 16-byte load in fp32, an 8-byte load in bf16), each M row reduced
// on its own. So a row's output bits do not depend on the batch it is in.
//
// Bound on the H100: bytes, the same as decode_attention.cu (K and V of the
// unmasked keys once). The 8-byte bf16 loads and the shuffle tree per key row
// cost time against that kernel; exactness of order comes first here.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 64;
constexpr int kEpl = 4;              // elements per lane
constexpr int kLpk = kDh / kEpl;     // 16 lanes per key row
constexpr int kKpw = 32 / kLpk;      // 2 key rows per warp load
constexpr int kStep = kWarps * kKpw; // 16 key rows per block load
constexpr int kUnroll = 4;           // key-row loads in flight per lane

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void unpack4(const float4& v, float* f) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack4(const uint2& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ float4 zero4(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ uint2 zero4(uint2) { return make_uint2(0u, 0u); }

// Block-wide sum in the fixed order of the header: lanes by a balanced tree,
// warps left to right, every add __fadd_rn.
__device__ __forceinline__ float block_sum_ordered(float x, float* red) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = __fadd_rn(x, red[w]);
  __syncthreads();
  return x;
}

template <typename T, int MM>
__global__ void __launch_bounds__(kThreads)
decode_attn_vpu_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ mask, T* __restrict__ o, int heads, int m,
                       int s_len, float scale) {
  using V = typename Vec4<T>::type;
  extern __shared__ float smem[];
  float* qs = smem;               // [m][kDh]
  float* sc = qs + m * kDh;       // [m][s_len] scores, then probs
  float* part = sc + m * s_len;   // [kWarps][m][kDh] partial contexts
  __shared__ float red[kWarps];

  const int bh = blockIdx.x, b = bh / heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kLpk;  // key row within the warp's load
  const int li = lane % kLpk;   // four-element run within the key row
  const T* qb = q + (size_t)bh * m * kDh;
  const V* kv = reinterpret_cast<const V*>(k + (size_t)bh * s_len * kDh);
  const V* vv = reinterpret_cast<const V*>(v + (size_t)bh * s_len * kDh);
  const float* mb = mask + (size_t)b * s_len;

  for (int i = tid; i < m * kDh; i += kThreads) qs[i] = cxr::to_float(qb[i]);
  __syncthreads();
  float qf[MM][kEpl];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) qf[r][e] = r < m ? qs[r * kDh + li * kEpl + e] : 0.f;

  // pass 1: scores
  // (the trip count depends on the warp alone: every lane joins the shuffles)
  for (int s0 = warp * kKpw; s0 < s_len; s0 += kStep * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      buf[u] = s < s_len ? __ldg(kv + (size_t)s * kLpk + li) : zero4(V());
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      float kf[kEpl];
      unpack4(buf[u], kf);
#pragma unroll
      for (int r = 0; r < MM; ++r) {
        float acc = __fadd_rn(__fmul_rn(kf[0], qf[r][0]), __fmul_rn(kf[1], qf[r][1]));
        acc = __fadd_rn(acc, __fmul_rn(kf[2], qf[r][2]));
        acc = __fadd_rn(acc, __fmul_rn(kf[3], qf[r][3]));
#pragma unroll
        for (int off = 1; off < kLpk; off <<= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        if (li == 0 && s < s_len && r < m)
          sc[r * s_len + s] = __fadd_rn(__fmul_rn(acc, scale), mb[s]);
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
      const float e = expf(__fsub_rn(row[i], mx));
      row[i] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_sum_ordered(sum, red);
    for (int i = tid; i < s_len; i += kThreads)
      row[i] = cxr::to_float(cxr::from_float<T>(__fdiv_rn(row[i], sum)));
  }
  __syncthreads();

  // pass 3: context = probs . V
  float cacc[MM][kEpl];
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) cacc[r][e] = 0.f;
  for (int s0 = warp * kKpw; s0 < s_len; s0 += kStep * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      buf[u] = s < s_len ? __ldg(vv + (size_t)s * kLpk + li) : zero4(V());
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kStep + sub;
      if (s < s_len) {
        float vf[kEpl];
        unpack4(buf[u], vf);
#pragma unroll
        for (int r = 0; r < MM; ++r) {
          const float p = r < m ? sc[r * s_len + s] : 0.f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) cacc[r][e] = __fadd_rn(cacc[r][e], __fmul_rn(p, vf[e]));
        }
      }
    }
  }
  // the warp's two key-row streams, then the warps left to right
#pragma unroll
  for (int r = 0; r < MM; ++r)
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      cacc[r][e] = __fadd_rn(cacc[r][e], __shfl_xor_sync(0xffffffffu, cacc[r][e], kLpk));
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < MM; ++r)
      if (r < m)
#pragma unroll
        for (int e = 0; e < kEpl; ++e) part[(warp * m + r) * kDh + li * kEpl + e] = cacc[r][e];
  }
  __syncthreads();
  T* ob = o + (size_t)bh * m * kDh;
  for (int i = tid; i < m * kDh; i += kThreads) {
    float x = part[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = __fadd_rn(x, part[w * m * kDh + i]);
    ob[i] = cxr::from_float<T>(x);
  }
}

template <typename T, int MM>
cudaError_t launch_mm(const void* q, const void* k, const void* v, const float* mask, void* o,
                      int bh, int heads, int m, int s_len, float scale, size_t smem,
                      cudaStream_t stream) {
  auto fn = decode_attn_vpu_kernel<T, MM>;
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

extern "C" int cxr_decode_attention_vpu_f32(const void* q, const void* k, const void* v,
                                            const void* mask, void* o, int bh, int heads, int m,
                                            int s_len, int dh, float scale, void* stream) {
  return launch<float>(q, k, v, mask, o, bh, heads, m, s_len, dh, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_vpu_bf16(const void* q, const void* k, const void* v,
                                             const void* mask, void* o, int bh, int heads, int m,
                                             int s_len, int dh, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, o, bh, heads, m, s_len, dh, scale,
                               static_cast<cudaStream_t>(stream));
}
