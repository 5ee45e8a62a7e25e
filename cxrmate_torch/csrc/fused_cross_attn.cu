// Fused step, kernel 3 of 4: cross-attention of one query per study over the
// encoder K/V.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:291 _cross_attn_kernel_v2 (the
// third pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside:
// scores = cq . K x scale + (1 - cross_mask) x finfo(f32).min; softmax; the
// probabilities stay fp32 (decode_attention rounds them to the input dtype,
// this body does not); ctx = probs . V, rounded to the hidden dtype. Query and
// context are [B, D] with the heads side by side, as the neighbouring dense
// kernels write and read them: no transposes between the four kernels.
//
// Bound on the H100: bytes: the K and V rows of the keys that are not masked
// (2 B H S dh elements at most, 70.8 MB in bf16 at B = 8, S = 2,880).
//
// Design: one block of 1,024 threads per (study, head) runs the attend routine
// of fused_decode.cuh: scores in shared memory, exact softmax, K rows of
// masked keys and V rows of keys with probability 0 are not loaded (the
// all-zero image slots of a study). A fully masked study gets the uniform
// softmax over all S keys, as the plain version gives it. A block streams its
// head's 737 KB alone, so it is as wide as a block can be: the loads in
// flight per SM, not the card's memory rate, set its time. 96 blocks leave a
// quarter of the SMs idle: splitting S over blocks is later work.
#include "fused_decode.cuh"

namespace {

using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cross_attn_kernel(const T* __restrict__ cq, const T* __restrict__ cross_k,
                  const T* __restrict__ cross_v, const int* __restrict__ cross_mask,
                  T* __restrict__ ctx, int heads, int s_len, int d_model, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kDh]
  float* sc = qs + kDh;                         // attend_floats(s_len, kWarps)
  __shared__ float red[kWarps];
  const int unit = blockIdx.x, b = unit / heads, h = unit - b * heads;
  const size_t at = (size_t)b * d_model + h * kDh;
  for (int i = threadIdx.x; i < kDh; i += kThreads) qs[i] = to_float(cq[at + i]);
  __syncthreads();
  const size_t base = (size_t)unit * s_len * kDh;
  attend<T, kWarps>(qs, cross_k + base, cross_v + base, cross_mask + (size_t)b * s_len, s_len,
                    s_len, false, nullptr, nullptr, false, scale, sc, red, ctx + at);
}

template <typename T>
cudaError_t launch(const void* cq, const void* cross_k, const void* cross_v,
                   const void* cross_mask, void* ctx, int batch, int heads, int s_len,
                   int d_model, int dh, float scale, cudaStream_t stream) {
  if (dh != kDh || d_model != heads * dh || s_len < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kDh + attend_floats(s_len, kWarps));
  auto fn = cross_attn_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(cq), static_cast<const T*>(cross_k), static_cast<const T*>(cross_v),
      static_cast<const int*>(cross_mask), static_cast<T*>(ctx), heads, s_len, d_model, scale);
  return cudaGetLastError();
}

}  // namespace

// Shapes: cq, ctx [batch, D]; cross_k/v [batch, heads, S, 64]; cross_mask
// [batch, S] int32, non-zero = may be attended.
extern "C" int cxr_fused_cross_attn_f32(const void* cq, const void* cross_k, const void* cross_v,
                                        const void* cross_mask, void* ctx, int batch, int heads,
                                        int s_len, int d_model, int dh, float scale,
                                        void* stream) {
  return launch<float>(cq, cross_k, cross_v, cross_mask, ctx, batch, heads, s_len, d_model, dh,
                       scale, static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_cross_attn_bf16(const void* cq, const void* cross_k, const void* cross_v,
                                         const void* cross_mask, void* ctx, int batch, int heads,
                                         int s_len, int d_model, int dh, float scale,
                                         void* stream) {
  return launch<__nv_bfloat16>(cq, cross_k, cross_v, cross_mask, ctx, batch, heads, s_len,
                               d_model, dh, scale, static_cast<cudaStream_t>(stream));
}
