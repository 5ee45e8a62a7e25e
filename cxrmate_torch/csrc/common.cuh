// Shared device helpers of the cxrmate_torch kernels: conversions between the
// storage types (fp32, bf16) and fp32 arithmetic, and block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cxr {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Unpack one 16-byte vector of T into 16 / sizeof(T) floats.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& v, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Block-wide max / sum of one float per thread. `red` holds one float per
// warp; every thread gets the result. Deterministic: warps combine in order.
template <int kWarps>
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

template <int kWarps>
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x += red[w];
  __syncthreads();
  return x;
}

}  // namespace cxr
