// Fused step, kernel 4 of 4: the cross-attention output projection and its
// residual LayerNorm, then the feed-forward block and the layer's last
// LayerNorm.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:320 _out_ln_ffn_kernel (the fourth
// pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside:
// h = LayerNorm(cctx . Wo^T + bo + res); z = gelu(h . W1^T + b1) with the
// exact erf GELU (the Pallas body spells erf by a rational approximation only
// because its compiler has none; erff here); out = LayerNorm(z . W2^T + b2 + h)
// with the unrounded h as the residual; only `out` is rounded, to the hidden
// dtype.
//
// Bound on the H100: bytes: Wo [D, D], W1 [F, D] and W2 [D, F] (10.6 MB in
// bf16 at D = 768, F = 3,072) for 2 B (D^2 + 2 D F) flops at B = 8.
//
// Design: two LayerNorms sit between three products, and each needs a whole
// row of the product before it. One cooperative launch, one block per SM,
// four stages with a grid-wide sync between them: dense pass over Wo -> y1
// (fp32 scratch); every block normalises y1 into its own shared memory (h,
// kept for the residual) and the grid shares the F outputs of W1, GELU in
// the epilogue -> z (scratch); every block loads z (96 KB at F = 3,072) and
// the grid shares the D outputs of W2 -> y2 (scratch); block 0 normalises y2
// into `out`. Every weight is read from device memory once for up to 8 rows;
// three syncs cost a few microseconds each. More than 8 studies run in
// chunks of 8.
#include "fused_decode.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_ln_ffn_kernel(const T* __restrict__ cctx, const T* __restrict__ res,
                  const T* __restrict__ wo, const T* __restrict__ bo,
                  const T* __restrict__ gamma2, const T* __restrict__ beta2,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  const T* __restrict__ gamma3, const T* __restrict__ beta3,
                  T* __restrict__ out, float* y1, float* z, float* y2, int batch, int d_model,
                  int d_ff, float eps) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][D]: h, the FFN's input and residual
  float* xs = hs + kRows * d_model;             // [kRows][max(D, F)]: a pass's input rows
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;

  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    const size_t off = (size_t)b0 * d_model, off_ff = (size_t)b0 * d_ff;
    load_rows<T>(cctx + off, rows, d_model, xs);
    __syncthreads();
    dense_pass<T>(
        xs, d_model, wo, d_model, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(bo[o]), to_float(res[off + (size_t)b * d_model + o]));
        },
        [&](int o, int b, float v, float2 a) {
          y1[off + (size_t)b * d_model + o] = (v + a.x) + a.y;
        });
    grid.sync();
    layer_norm_rows<T, kWarps>(y1 + off, rows, d_model, gamma2, beta2, eps, hs, nullptr);
    __syncthreads();
    dense_pass<T>(
        hs, d_model, w1, d_ff, rows, gwarp, gwarps,
        [&](int o, int b) { return make_float2(to_float(b1[o]), 0.f); },
        [&](int o, int b, float v, float2 add) {
          const float a = v + add.x;
          z[off_ff + (size_t)b * d_ff + o] = a * (0.5f * (1.0f + erff(a * 0.70710678118654752f)));
        });
    grid.sync();
    load_scratch_rows<T>(z + off_ff, rows, d_ff, xs);
    __syncthreads();
    dense_pass<T>(
        xs, d_ff, w2, d_model, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(b2[o]), hs[b * d_model + xs_pos<T>(o, d_model)]);
        },
        [&](int o, int b, float v, float2 a) {
          y2[off + (size_t)b * d_model + o] = (v + a.x) + a.y;
        });
    grid.sync();
    if (blockIdx.x == 0)
      layer_norm_rows<T, kWarps>(y2 + off, rows, d_model, gamma3, beta3, eps, xs, out + off);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* cctx, const void* res, const void* wo, const void* bo,
                   const void* gamma2, const void* beta2, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* gamma3, const void* beta3,
                   void* out, void* scratch, int batch, int d_model, int d_ff, float eps,
                   cudaStream_t stream) {
  if (d_model < 8 || d_model % 8 != 0 || d_ff < 8 || d_ff % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * kRows * ((size_t)d_model + (d_ff > d_model ? d_ff : d_model));
  const void* fn = reinterpret_cast<const void*>(&out_ln_ffn_kernel<T>);
  static int grid = 0;
  static size_t grid_smem = 0;
  if (grid == 0 || smem != grid_smem) {
    const cudaError_t err = cooperative_grid(fn, kThreads, smem, &grid);
    if (err != cudaSuccess) return err;
    grid_smem = smem;
  }
  const T* a_cctx = static_cast<const T*>(cctx);
  const T* a_res = static_cast<const T*>(res);
  const T* a_wo = static_cast<const T*>(wo);
  const T* a_bo = static_cast<const T*>(bo);
  const T* a_g2 = static_cast<const T*>(gamma2);
  const T* a_be2 = static_cast<const T*>(beta2);
  const T* a_w1 = static_cast<const T*>(w1);
  const T* a_b1 = static_cast<const T*>(b1);
  const T* a_w2 = static_cast<const T*>(w2);
  const T* a_b2 = static_cast<const T*>(b2);
  const T* a_g3 = static_cast<const T*>(gamma3);
  const T* a_be3 = static_cast<const T*>(beta3);
  T* a_out = static_cast<T*>(out);
  // scratch: y1 [batch, D], y2 [batch, D], z [batch, F]
  float* a_y1 = static_cast<float*>(scratch);
  float* a_y2 = a_y1 + (size_t)batch * d_model;
  float* a_z = a_y2 + (size_t)batch * d_model;
  void* args[] = {&a_cctx, &a_res, &a_wo, &a_bo, &a_g2, &a_be2, &a_w1, &a_b1, &a_w2, &a_b2,
                  &a_g3, &a_be3, &a_out, &a_y1, &a_z, &a_y2, &batch, &d_model, &d_ff, &eps};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
}

}  // namespace

// Shapes: cctx, res, out [batch, D]; wo [D, D], w1 [F, D], w2 [D, F]
// ([out, in]); bo, b2 and the LayerNorm vectors [D]; b1 [F]; scratch fp32
// [batch, 2D + F].
extern "C" int cxr_fused_out_ln_ffn_f32(const void* cctx, const void* res, const void* wo,
                                        const void* bo, const void* gamma2, const void* beta2,
                                        const void* w1, const void* b1, const void* w2,
                                        const void* b2, const void* gamma3, const void* beta3,
                                        void* out, void* scratch, int batch, int d_model,
                                        int d_ff, float eps, void* stream) {
  return launch<float>(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3, beta3, out,
                       scratch, batch, d_model, d_ff, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_out_ln_ffn_bf16(const void* cctx, const void* res, const void* wo,
                                         const void* bo, const void* gamma2, const void* beta2,
                                         const void* w1, const void* b1, const void* w2,
                                         const void* b2, const void* gamma3, const void* beta3,
                                         void* out, void* scratch, int batch, int d_model,
                                         int d_ff, float eps, void* stream) {
  return launch<__nv_bfloat16>(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3, beta3,
                               out, scratch, batch, d_model, d_ff, eps,
                               static_cast<cudaStream_t>(stream));
}
