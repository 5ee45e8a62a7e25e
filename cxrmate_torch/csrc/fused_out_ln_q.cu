// Fused step, kernel 2 of 4: the self-attention output projection, the
// residual LayerNorm and the cross-attention query projection.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:304 _out_ln_q_kernel (the second
// pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside:
// y = LayerNorm(ctx . Wo^T + bo + res); h1 = y rounded to the hidden dtype;
// cq = y . Wq^T + bq from the UNROUNDED y, rounded to the hidden dtype.
//
// Bound on the H100: bytes: two [D, D] weights (2.4 MB in bf16 at D = 768)
// for 4 B D^2 flops at B = 8.
//
// Design: the LayerNorm needs the whole row of the first product before the
// second can start. One cooperative launch, one block per SM: a dense pass
// over Wo (the grid's warps share the D outputs, up to 8 rows per weight
// read) leaves y in an fp32 scratch buffer; a grid-wide sync; every block
// normalises the rows itself into its shared memory (block 0 also writes h1)
// and the grid shares the D outputs of Wq. The sync costs a few microseconds;
// a block per batch row would need none but would pull every weight through
// one SM once per row.
#include "fused_decode.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_ln_q_kernel(const T* __restrict__ ctx, const T* __restrict__ res, const T* __restrict__ wo,
                const T* __restrict__ bo, const T* __restrict__ gamma,
                const T* __restrict__ beta, const T* __restrict__ wq, const T* __restrict__ bq,
                T* __restrict__ h_out, T* __restrict__ q_out, float* y, int batch, int d_model,
                float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kRows][D]
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;

  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    const size_t off = (size_t)b0 * d_model;
    load_rows<T>(ctx + off, rows, d_model, xs);
    __syncthreads();
    dense_pass<T>(
        xs, d_model, wo, d_model, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(bo[o]), to_float(res[off + (size_t)b * d_model + o]));
        },
        [&](int o, int b, float v, float2 a) {
          y[off + (size_t)b * d_model + o] = (v + a.x) + a.y;
        });
    grid.sync();
    layer_norm_rows<T, kWarps>(y + off, rows, d_model, gamma, beta, eps, xs,
                               blockIdx.x == 0 ? h_out + off : nullptr);
    __syncthreads();
    dense_pass<T>(
        xs, d_model, wq, d_model, rows, gwarp, gwarps,
        [&](int o, int b) { return make_float2(to_float(bq[o]), 0.f); },
        [&](int o, int b, float v, float2 a) {
          q_out[off + (size_t)b * d_model + o] = from_float<T>(v + a.x);
        });
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* ctx, const void* res, const void* wo, const void* bo,
                   const void* gamma, const void* beta, const void* wq, const void* bq,
                   void* h_out, void* q_out, void* scratch, int batch, int d_model, float eps,
                   cudaStream_t stream) {
  if (d_model < 8 || d_model % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kRows * d_model;
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
