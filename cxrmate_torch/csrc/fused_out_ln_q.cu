// Fused step, kernel 2 of 4: the self-attention output projection, the
// residual LayerNorm and the cross-attention query projection.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:304 _out_ln_q_kernel (the second
// pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside:
// y = LayerNorm(ctx . Wo^T + bo + res); h1 = y rounded to the hidden dtype;
// cq = y . Wq^T + bq from the UNROUNDED y, rounded to the hidden dtype.
//
// Bound on the H100: bytes: two [D, D] weights (2.4 MB in bf16 at D = 768,
// 0.72 us at 3.35 TB/s) for 4 B D^2 flops at B = 8.
//
// Design: the LayerNorm needs the whole row of the first product before the
// second can start. One cooperative launch, one block of 16 warps per SM,
// both products split-K passes over every warp of the grid (fused_decode.cuh:
// out_ln_q_passes, shared with v1's fused_layer_step.cu): block b owns the
// outputs [D b / G, D (b + 1) / G) of Wo and of Wq, whose 512-byte K-slices
// (3 a row in bf16, 6 in fp32 at D = 768) its warps share in contiguous
// runs, every unit of a warp in flight at once; the slices' partials are
// added in slice order through shared memory, bias and residual in the
// epilogue, y to an fp32 scratch buffer; a grid-wide sync; every block
// normalises the rows into its shared memory (block 0 also writes h1) and
// runs the Wq pass the same way. A row's bits depend neither on the card,
// the grid nor the batch. Each block asks L2 for its rows of Wo and Wq once
// ctx's loads are on their way (asked at launch, they would queue ctx's
// loads behind them), and L1 for the LayerNorm's gamma and beta before the
// sync, so that after it the block waits only for the rows.
#include "fused_decode.cuh"

namespace {

using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = kPassThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_ln_q_kernel(const T* __restrict__ ctx, const T* __restrict__ res, const T* __restrict__ wo,
                const T* __restrict__ bo, const T* __restrict__ gamma,
                const T* __restrict__ beta, const T* __restrict__ wq, const T* __restrict__ bq,
                T* __restrict__ h_out, T* __restrict__ q_out, float* y, int batch, int d_model,
                float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kRows][D], then the slices' partials
  cg::grid_group grid = cg::this_grid();
  const int2 own = block_share(d_model);

  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    const size_t off = (size_t)b0 * d_model;
    const auto ask = [&] {  // the block's rows of both weights, once
      if (b0 == 0) {
        prefetch_rows(wo, own, d_model);
        prefetch_rows(wq, own, d_model);
      }
    };
    load_rows<T>(ctx + off, rows, d_model, xs, ask);
    __syncthreads();
    out_ln_q_passes<T, T>(grid, xs, rows, off, d_model, res, wo, bo, gamma, beta, wq, bq, eps, y,
                          h_out, q_out);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* ctx, const void* res, const void* wo, const void* bo,
                   const void* gamma, const void* beta, const void* wq, const void* bq,
                   void* h_out, void* q_out, void* scratch, int batch, int d_model, float eps,
                   cudaStream_t stream) {
  if (d_model < 8 || d_model % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * kRows * d_model;  // the rows, then the partials
  const void* fn = reinterpret_cast<const void*>(&out_ln_q_kernel<T>);
  static int grid = 0;
  static size_t grid_smem = 0;
  if (grid == 0 || smem != grid_smem) {
    const cudaError_t err = cooperative_grid(fn, kThreads, smem, &grid);
    if (err != cudaSuccess) return err;
    grid_smem = smem;
  }
  const T* a_ctx = static_cast<const T*>(ctx);
  const T* a_res = static_cast<const T*>(res);
  const T* a_wo = static_cast<const T*>(wo);
  const T* a_bo = static_cast<const T*>(bo);
  const T* a_gamma = static_cast<const T*>(gamma);
  const T* a_beta = static_cast<const T*>(beta);
  const T* a_wq = static_cast<const T*>(wq);
  const T* a_bq = static_cast<const T*>(bq);
  T* a_h = static_cast<T*>(h_out);
  T* a_q = static_cast<T*>(q_out);
  float* a_y = static_cast<float*>(scratch);
  void* args[] = {&a_ctx, &a_res, &a_wo, &a_bo, &a_gamma, &a_beta, &a_wq, &a_bq,
                  &a_h, &a_q, &a_y, &batch, &d_model, &eps};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
}

}  // namespace

// Shapes: ctx, res, h_out, q_out [batch, D]; wo, wq [D, D] ([out, in]); bo,
// gamma, beta, bq [D]; scratch fp32 [batch, D].
extern "C" int cxr_fused_out_ln_q_f32(const void* ctx, const void* res, const void* wo,
                                      const void* bo, const void* gamma, const void* beta,
                                      const void* wq, const void* bq, void* h_out, void* q_out,
                                      void* scratch, int batch, int d_model, float eps,
                                      void* stream) {
  return launch<float>(ctx, res, wo, bo, gamma, beta, wq, bq, h_out, q_out, scratch, batch,
                       d_model, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_out_ln_q_bf16(const void* ctx, const void* res, const void* wo,
                                       const void* bo, const void* gamma, const void* beta,
                                       const void* wq, const void* bq, void* h_out, void* q_out,
                                       void* scratch, int batch, int d_model, float eps,
                                       void* stream) {
  return launch<__nv_bfloat16>(ctx, res, wo, bo, gamma, beta, wq, bq, h_out, q_out, scratch,
                               batch, d_model, eps, static_cast<cudaStream_t>(stream));
}
