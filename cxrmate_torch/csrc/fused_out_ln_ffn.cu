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
// bf16 at D = 768, F = 3,072, 3.2 us at 3.35 TB/s) for 2 B (D^2 + 2 D F)
// flops at B = 8.
//
// Design: two LayerNorms sit between three products, and each needs a whole
// row of the product before it. One cooperative launch, one block of 16 warps
// per SM, a grid-wide sync between the stages (fused_decode.cuh:
// out_ln_ffn_passes, shared with v1's fused_layer_step.cu). Each product is
// a split-K pass over every warp of the grid: a unit is one output's K-slice
// of 32 16-byte
// weight vectors (512 bytes), one vector a lane, multiplied with the lane's
// input values of up to 8 rows from shared memory and summed over the warp;
// a warp takes a contiguous run of units and has the weights of up to kBatch
// of them in flight. The number of K-slices is a function of the input width
// and the dtype alone, and an output's slices are added in slice order, so a
// row's bits depend neither on the card, the grid nor the batch. At launch every block
// asks L2 for its 1 / G share of Wo's rows (cp.async.bulk.prefetch.L2), in
// flight while cctx is loaded; W1 and W2 are not prefetched: a pass reads
// its 4.7 MB at the memory rate well inside its own time (the x reads from
// shared memory bound it), and a 9.4 MB prefetch stream at launch measured
// slower, stretching the latency-bound LayerNorms and syncs it overlapped
// (PERF.md). A LayerNorm's vectors are asked into L1 before the grid sync
// that precedes it, so that it waits only for the rows.
//   Wo: the block's outputs [D b / G, D (b + 1) / G), their slices' partials
//     reduced through shared memory -> y1 (fp32 scratch); grid sync; every
//     block normalises y1 into its own shared memory (h, the FFN's input
//     and residual);
//   W1: the block's outputs [F b / G, F (b + 1) / G) likewise, GELU in the
//     epilogue -> z (scratch); grid sync;
//   W2: the units (slice k, output o), slice by slice, cut into G equal
//     runs, one a block: a block loads only its slices' columns of z, and
//     writes each unit's partial to scratch; grid sync;
//   the last LayerNorm, one row a block: its slices' partials added in
//     slice order, + b2 + h, normalised into `out`.
// More than 8 studies run in chunks of 8, which find the weights in L2.
#include "fused_decode.cuh"

namespace {

using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = kPassThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_ln_ffn_kernel(const T* __restrict__ cctx, const T* __restrict__ res,
                  const T* __restrict__ wo, const T* __restrict__ bo,
                  const T* __restrict__ gamma2, const T* __restrict__ beta2,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  const T* __restrict__ gamma3, const T* __restrict__ beta3,
                  T* __restrict__ out, float* y1, float* z, float* p2, int batch, int d_model,
                  int d_ff, float eps) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][D]: h, the FFN's input and residual
  float* xs = hs + kRows * d_model;             // [kRows][max(D, F)]: a pass's input rows
  cg::grid_group grid = cg::this_grid();

  // Wo to L2 at launch, each block a 1 / G share of its rows, in flight while
  // cctx is loaded
  prefetch_rows(wo, block_share(d_model), d_model);
  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    const size_t off = (size_t)b0 * d_model, off_ff = (size_t)b0 * d_ff;
    load_rows<T>(cctx + off, rows, d_model, xs);
    __syncthreads();
    out_ln_ffn_passes<T>(
        grid, hs, xs, rows, off, off_ff, d_model, d_ff,
        [&](int o, int b) { return to_float(res[off + (size_t)b * d_model + o]); }, wo, bo,
        gamma2, beta2, w1, b1, w2, b2, gamma3, beta3, eps, y1, z, p2, out);
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
  // scratch: y1 [batch, D], z [batch, F], W2's partials [slices(F)][kRows][D]
  float* a_y1 = static_cast<float*>(scratch);
  float* a_z = a_y1 + (size_t)batch * d_model;
  float* a_p2 = a_z + (size_t)batch * d_ff;
  void* args[] = {&a_cctx, &a_res, &a_wo, &a_bo, &a_g2, &a_be2, &a_w1, &a_b1, &a_w2, &a_b2,
                  &a_g3, &a_be3, &a_out, &a_y1, &a_z, &a_p2, &batch, &d_model, &d_ff, &eps};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
}

}  // namespace

// Shapes: cctx, res, out [batch, D]; wo [D, D], w1 [F, D], w2 [D, F]
// ([out, in]); bo, b2 and the LayerNorm vectors [D]; b1 [F]; scratch fp32
// [batch (D + F) + slices(F) 8 D], slices(n) = ceil(n / (16 / sizeof(T)) / 32).
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
