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
// per SM, a grid-wide sync between the stages. Each product is a split-K pass
// over every warp of the grid: a unit is one output's K-slice of 32 16-byte
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

namespace cg = cooperative_groups;
using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = kPassThreads;
constexpr int kWarps = kThreads / 32;

// Columns [c0, c1) (multiples of 4) of rows [0, rows) of a [rows, n] fp32
// array another block wrote during this launch -> xs (dense-pass layout);
// the same columns of rows [rows, kRows) are zeroed.
template <typename T>
__device__ __forceinline__ void load_scratch_cols(const float* src, int rows, int n, int c0,
                                                  int c1, float* xs) {
  const int nq = (c1 - c0) / 4;
  for (int i = threadIdx.x; i < kRows * nq; i += kThreads) {
    const int r = i / nq, c = c0 + 4 * (i - r * nq);
    const float4 v = r < rows ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * n + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(xs + r * n + xs_pos<T>(c, n)) = v;
  }
}

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
  constexpr int VPR = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [kRows][D]: h, the FFN's input and residual
  float* xs = hs + kRows * d_model;             // [kRows][max(D, F)]: a pass's input rows
  cg::grid_group grid = cg::this_grid();
  const int g = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int lo_o = (int)((long)d_model * blk / g), hi_o = (int)((long)d_model * (blk + 1) / g);
  const int lo_1 = (int)((long)d_ff * blk / g), hi_1 = (int)((long)d_ff * (blk + 1) / g);
  const int ks2 = slices<T>(d_ff), n2 = ks2 * d_model, slice = kSliceVecs * VPR;
  const int lo_2 = (int)((long)n2 * blk / g), hi_2 = (int)((long)n2 * (blk + 1) / g);
  const int f_wide = d_ff > d_model ? d_ff : d_model;

  // Wo to L2 at launch, each block a 1 / G share of its rows, in flight while
  // cctx is loaded
  prefetch_range(wo + (size_t)lo_o * d_model, sizeof(T) * (size_t)(hi_o - lo_o) * d_model);
  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    const size_t off = (size_t)b0 * d_model, off_ff = (size_t)b0 * d_ff;
    load_rows<T>(cctx + off, rows, d_model, xs);
    __syncthreads();
    // Wo: the partials in hs, free until the LayerNorm
    block_outputs<T>(
        xs, d_model, wo, lo_o, hi_o, rows, hs, d_model / slices<T>(d_model),
        [&](int o, int b) {
          return make_float2(to_float(bo[o]), to_float(res[off + (size_t)b * d_model + o]));
        },
        [&](int o, int b, float y, float2 a) {
          y1[off + (size_t)b * d_model + o] = (y + a.x) + a.y;
        });
    prefetch_l1(gamma2, d_model);
    prefetch_l1(beta2, d_model);
    grid.sync();
    layer_norm_rows<T, kWarps>(y1 + off, rows, d_model, gamma2, beta2, eps, hs, nullptr);
    __syncthreads();
    // W1: the partials in xs, free until z is loaded
    block_outputs<T>(
        hs, d_model, w1, lo_1, hi_1, rows, xs, f_wide / slices<T>(d_model),
        [&](int o, int) { return make_float2(to_float(b1[o]), 0.f); },
        [&](int o, int b, float y, float2 add) {
          const float a = y + add.x;
          z[off_ff + (size_t)b * d_ff + o] = a * (0.5f * (1.0f + erff(a * 0.70710678118654752f)));
        });
    grid.sync();
    // W2: only the columns of z the block's slices read
    if (lo_2 < hi_2) {
      const int k0 = lo_2 / d_model, k1 = (hi_2 - 1) / d_model;
      load_scratch_cols<T>(z + off_ff, rows, d_ff, k0 * slice, min(d_ff, (k1 + 1) * slice), xs);
      __syncthreads();
      split_pass<T>(xs, d_ff, w2, 0, d_model, lo_2, hi_2, rows,
                    [&](int, int o, int k, int b, float y) {
                      p2[((size_t)k * kRows + b) * d_model + o] = y;
                    });
    }
    if (blk < rows) {
      prefetch_l1(b2, d_model);
      prefetch_l1(gamma3, d_model);
      prefetch_l1(beta3, d_model);
    }
    grid.sync();
    // the last LayerNorm, one row a block: y2 = (sum of the slices' partials
    // + b2) + h, the row in xs[0, D), the block's warp sums after it
    float* red = xs + d_model;
    for (int r = blk; r < rows; r += g) {
      float s = 0.f;
      for (int o = tid; o < d_model; o += kThreads) {
        float y = 0.f;
        for (int k0 = 0; k0 < ks2; k0 += 8) {  // eight partials in flight, added in order
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = k0 + k < ks2 ? __ldcg(p2 + ((size_t)(k0 + k) * kRows + r) * d_model + o) : 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (k0 + k < ks2) y += v[k];
        }
        y = (y + to_float(b2[o])) + hs[r * d_model + xs_pos<T>(o, d_model)];
        xs[o] = y;
        s += y;
      }
      const float mean = block_sum<kWarps>(s, red) / (float)d_model;
      float q = 0.f;
      for (int o = tid; o < d_model; o += kThreads) {
        const float d = xs[o] - mean;
        q += d * d;
      }
      const float rstd = 1.0f / sqrtf(block_sum<kWarps>(q, red) / (float)d_model + eps);
      T* orow = out + off + (size_t)r * d_model;
      for (int o = tid; o < d_model; o += kThreads)
        orow[o] = from_float<T>((xs[o] - mean) * rstd * to_float(gamma3[o]) +
                                to_float(beta3[o]));
    }
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
