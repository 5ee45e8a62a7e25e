// Fused step v1: one whole BERT decoder layer for one new token per study, in
// one launch.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:164 fused_layer_step (its one
// pallas_call, :201, the body _kernel :71). Contract, fp32 from the input to
// the three outputs: q, k_new, v_new = hidden . Wqkv^T + b; self-attention over
// the T cached keys masked by key_mask * (col < index) plus the new token as
// one more column (scored and weighted with the unrounded k_new/v_new, masked
// by key_mask[:, index]: a masked query does not attend to itself); scores
// s * scale + (1 - mask) * finfo(f32).min, exact softmax; h1 =
// LayerNorm(ctx . Wo^T + bo + hidden); cq = h1 . Wcq^T + bcq; cross-attention
// over cross_k/v under cross_mask; h2 = LayerNorm(cctx . Wco^T + bco + h1);
// out = LayerNorm(gelu(h2 . W1^T + b1) . W2^T + b2 + h2) with the exact erf
// GELU (erff; the Pallas body's Abramowitz-Stegun erf is within 1.5e-7) and
// eps from the caller. Only out (hidden dtype) and the new K/V column (cache
// dtype, written into column `index` of the cache in place) are rounded; ctx,
// h1, cq, cctx and the FFN activations stay fp32. That is where v1 differs
// from v2 (fused_qkv_attn.cu ... fused_out_ln_ffn.cu), which rounds ctx, h1,
// cq and cctx to the hidden dtype between its four kernels.
//
// Bound on the H100: bytes. The layer's weights (4 D^2 + 2 D F elements, 14.2
// MB in bf16 at D = 768, F = 3,072) are read once for all rows; the self and
// cross K/V rows the masks leave open (70.8 MB of cross K/V at most, in bf16,
// at B = 8, S = 2,880).
//
// Design: v2's stages in one cooperative launch (one block of 512 threads per
// SM, all co-resident), with a grid-wide sync wherever a stage needs the whole
// output of the one before, and fp32 scratch between the stages (read past L1,
// __ldcg, since other SMs wrote it): QKV dense pass -> sync -> self-attention,
// one (study, head) per block, the attend routine of fused_decode.cuh with the
// new token as the extra column, then the cache column written -> sync ->
// out-projection dense pass -> sync -> every block normalises h1 into its own
// shared memory (block 0 also keeps it in scratch as the next residual) and
// the grid shares the Wcq outputs -> sync -> cross-attention per (study,
// head) -> sync -> Wco pass -> sync -> LayerNorm, W1 pass with the GELU ->
// sync -> W2 pass -> sync -> block 0's last LayerNorm into `out`. Every
// weight is read once for up to 8 rows; more studies run the dense stages in
// chunks of 8. Simple and right first: the cross stage runs 16 warps per
// (study, head) where v2's kernel runs 32, and seven syncs cost a few
// microseconds each.
#include "fused_decode.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPointers = 27;

template <typename T>
struct StepArgs {
  const T *hidden, *wqkv, *bqkv;
  const T *wo, *bo, *g1, *be1, *wcq, *bcq;                        // self out, LN 1, cross q
  const T *wco, *bco, *g2, *be2, *w1, *b1, *w2, *b2, *g3, *be3;   // cross out, LN 2, FFN, LN 3
  T *cache_k, *cache_v;
  const T *cross_k, *cross_v;
  const int *key_mask, *cross_mask;
  T* out;
  float* scratch;
  int batch, heads, t_len, s_len, d_model, d_ff, index;
  float scale, eps;
};

// Shared memory (floats): the largest of a dense pass's 8 input rows, the
// self and the cross attention, and the FFN's 8 rows of h2 beside 8 of z.
__host__ __device__ inline size_t smem_floats(int d_model, int d_ff, int t_len, int s_len) {
  const size_t dense = (size_t)kRows * d_model;
  const size_t self_attn = 3 * kDh + attend_floats(t_len, kWarps);
  const size_t cross_attn = kDh + attend_floats(s_len, kWarps);
  const size_t ffn = (size_t)kRows * (d_model + (d_ff > d_model ? d_ff : d_model));
  size_t m = dense > self_attn ? dense : self_attn;
  m = m > cross_attn ? m : cross_attn;
  return m > ffn ? m : ffn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) layer_step_kernel(const StepArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;
  const int d = a.d_model, f = a.d_ff, d3 = 3 * d;
  // fp32 scratch, each [batch, width]
  float* qkv = a.scratch;                        // 3D
  float* ctx = qkv + (size_t)a.batch * d3;       // D
  float* y1 = ctx + (size_t)a.batch * d;         // D: before LayerNorm 1
  float* h1 = y1 + (size_t)a.batch * d;          // D
  float* cq = h1 + (size_t)a.batch * d;          // D
  float* cctx = cq + (size_t)a.batch * d;        // D
  float* y2 = cctx + (size_t)a.batch * d;        // D: before LayerNorm 2
  float* y3 = y2 + (size_t)a.batch * d;          // D: before LayerNorm 3
  float* z = y3 + (size_t)a.batch * d;           // F

  // 1. q, k_new, v_new of every row
  for (int b0 = 0; b0 < a.batch; b0 += kRows) {
    const int rows = min(kRows, a.batch - b0);
    load_rows<T>(a.hidden + (size_t)b0 * d, rows, d, smem);
    __syncthreads();
    dense_pass<T>(
        smem, d, a.wqkv, d3, rows, gwarp, gwarps,
        [&](int o, int b) { return make_float2(to_float(a.bqkv[o]), 0.f); },
        [&](int o, int b, float y, float2 add) { qkv[(size_t)(b0 + b) * d3 + o] = y + add.x; });
    __syncthreads();
  }
  grid.sync();

  // 2. self-attention, one (study, head) per block in turn; then its column
  {
    float* qs = smem;      // [kDh]
    float* kn = qs + kDh;  // [kDh]
    float* vn = kn + kDh;  // [kDh]
    float* sc = vn + kDh;  // attend_floats(t_len, kWarps)
    for (int unit = blockIdx.x; unit < a.batch * a.heads; unit += gridDim.x) {
      const int b = unit / a.heads, h = unit - b * a.heads;
      const float* row = qkv + (size_t)b * d3 + h * kDh;
      for (int i = threadIdx.x; i < 3 * kDh; i += kThreads)
        qs[i] = __ldcg(row + (i / kDh) * d + (i % kDh));
      __syncthreads();
      const size_t base = (size_t)unit * a.t_len * kDh;
      const int* mask = a.key_mask + (size_t)b * a.t_len;
      attend<T, kWarps, float>(qs, a.cache_k + base, a.cache_v + base, mask, a.t_len, a.index,
                               true, kn, vn, mask[a.index] != 0, a.scale, sc, red,
                               ctx + (size_t)b * d + h * kDh);
      for (int i = threadIdx.x; i < kDh; i += kThreads) {  // the head's reads are done
        a.cache_k[base + (size_t)a.index * kDh + i] = from_float<T>(kn[i]);
        a.cache_v[base + (size_t)a.index * kDh + i] = from_float<T>(vn[i]);
      }
      __syncthreads();
    }
  }
  grid.sync();

  // 3. h1 = LayerNorm(ctx Wo^T + bo + hidden); cq = h1 Wcq^T + bcq
  for (int b0 = 0; b0 < a.batch; b0 += kRows) {
    const int rows = min(kRows, a.batch - b0);
    const size_t off = (size_t)b0 * d;
    load_scratch_rows<T>(ctx + off, rows, d, smem);
    __syncthreads();
    dense_pass<T>(
        smem, d, a.wo, d, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(a.bo[o]), to_float(a.hidden[off + (size_t)b * d + o]));
        },
        [&](int o, int b, float v, float2 add) {
          y1[off + (size_t)b * d + o] = (v + add.x) + add.y;
        });
    grid.sync();
    layer_norm_rows<T, kWarps, float>(y1 + off, rows, d, a.g1, a.be1, a.eps, smem,
                                      blockIdx.x == 0 ? h1 + off : nullptr);
    __syncthreads();
    dense_pass<T>(
        smem, d, a.wcq, d, rows, gwarp, gwarps,
        [&](int o, int b) { return make_float2(to_float(a.bcq[o]), 0.f); },
        [&](int o, int b, float v, float2 add) { cq[off + (size_t)b * d + o] = v + add.x; });
    __syncthreads();
  }
  grid.sync();

  // 4. cross-attention, one (study, head) per block in turn
  {
    float* qs = smem;      // [kDh]
    float* sc = qs + kDh;  // attend_floats(s_len, kWarps)
    for (int unit = blockIdx.x; unit < a.batch * a.heads; unit += gridDim.x) {
      const int b = unit / a.heads, h = unit - b * a.heads;
      const size_t at = (size_t)b * d + h * kDh;
      for (int i = threadIdx.x; i < kDh; i += kThreads) qs[i] = __ldcg(cq + at + i);
      __syncthreads();
      const size_t base = (size_t)unit * a.s_len * kDh;
      attend<T, kWarps, float>(qs, a.cross_k + base, a.cross_v + base,
                               a.cross_mask + (size_t)b * a.s_len, a.s_len, a.s_len, false,
                               nullptr, nullptr, false, a.scale, sc, red, cctx + at);
    }
  }
  grid.sync();

  // 5. h2 = LayerNorm(cctx Wco^T + bco + h1); out = LayerNorm(gelu(h2 W1^T +
  // b1) W2^T + b2 + h2)
  float* hs = smem;               // [kRows][D]: h2, the FFN's input and residual
  float* xs = hs + kRows * d;     // [kRows][max(D, F)]: a pass's input rows
  for (int b0 = 0; b0 < a.batch; b0 += kRows) {
    const int rows = min(kRows, a.batch - b0);
    const size_t off = (size_t)b0 * d, off_ff = (size_t)b0 * f;
    load_scratch_rows<T>(cctx + off, rows, d, xs);
    __syncthreads();
    dense_pass<T>(
        xs, d, a.wco, d, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(a.bco[o]), __ldcg(h1 + off + (size_t)b * d + o));
        },
        [&](int o, int b, float v, float2 add) {
          y2[off + (size_t)b * d + o] = (v + add.x) + add.y;
        });
    grid.sync();
    layer_norm_rows<T, kWarps, float>(y2 + off, rows, d, a.g2, a.be2, a.eps, hs, nullptr);
    __syncthreads();
    dense_pass<T>(
        hs, d, a.w1, f, rows, gwarp, gwarps,
        [&](int o, int b) { return make_float2(to_float(a.b1[o]), 0.f); },
        [&](int o, int b, float v, float2 add) {
          const float x = v + add.x;
          z[off_ff + (size_t)b * f + o] = x * (0.5f * (1.0f + erff(x * 0.70710678118654752f)));
        });
    grid.sync();
    load_scratch_rows<T>(z + off_ff, rows, f, xs);
    __syncthreads();
    dense_pass<T>(
        xs, f, a.w2, d, rows, gwarp, gwarps,
        [&](int o, int b) {
          return make_float2(to_float(a.b2[o]), hs[b * d + xs_pos<T>(o, d)]);
        },
        [&](int o, int b, float v, float2 add) {
          y3[off + (size_t)b * d + o] = (v + add.x) + add.y;
        });
    grid.sync();
    if (blockIdx.x == 0)
      layer_norm_rows<T, kWarps>(y3 + off, rows, d, a.g3, a.be3, a.eps, xs, a.out + off);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int batch, int heads, int t_len, int s_len,
                   int d_model, int d_ff, int dh, int index, float scale, float eps,
                   cudaStream_t stream) {
  if (dh != kDh || d_model != heads * dh || d_model % 8 != 0 || d_ff < 8 || d_ff % 8 != 0 ||
      index < 0 || index >= t_len || s_len < 1)
    return cudaErrorInvalidValue;
  StepArgs<T> a;
  const T** in[] = {&a.hidden, &a.wqkv, &a.bqkv, &a.wo, &a.bo, &a.g1, &a.be1, &a.wcq, &a.bcq,
                    &a.wco, &a.bco, &a.g2, &a.be2, &a.w1, &a.b1, &a.w2, &a.b2, &a.g3, &a.be3};
  int p = 0;
  for (const T** slot : in) *slot = static_cast<const T*>(ptrs[p++]);
  a.cache_k = static_cast<T*>(const_cast<void*>(ptrs[p++]));
  a.cache_v = static_cast<T*>(const_cast<void*>(ptrs[p++]));
  a.cross_k = static_cast<const T*>(ptrs[p++]);
  a.cross_v = static_cast<const T*>(ptrs[p++]);
  a.key_mask = static_cast<const int*>(ptrs[p++]);
  a.cross_mask = static_cast<const int*>(ptrs[p++]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[p++]));
  a.scratch = static_cast<float*>(const_cast<void*>(ptrs[p++]));
  if (p != kPointers) return cudaErrorInvalidValue;
  a.batch = batch;
  a.heads = heads;
  a.t_len = t_len;
  a.s_len = s_len;
  a.d_model = d_model;
  a.d_ff = d_ff;
  a.index = index;
  a.scale = scale;
  a.eps = eps;
  const size_t smem = sizeof(float) * smem_floats(d_model, d_ff, t_len, s_len);
  const void* fn = reinterpret_cast<const void*>(&layer_step_kernel<T>);
  static int grid = 0;
  static size_t grid_smem = 0;
  if (grid == 0 || smem != grid_smem) {
    const cudaError_t err = cooperative_grid(fn, kThreads, smem, &grid);
    if (err != cudaSuccess) return err;
    grid_smem = smem;
  }
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
}

}  // namespace

// ptrs, in order: hidden [batch, D]; wqkv [3D, D], bqkv [3D]; wo [D, D], bo,
// LayerNorm 1 gamma and beta [D], wcq [D, D], bcq [D]; wco [D, D], bco,
// LayerNorm 2 gamma and beta [D], w1 [F, D], b1 [F], w2 [D, F], b2 [D],
// LayerNorm 3 gamma and beta [D] (weights [out, in]); cache_k/v
// [batch, heads, T, 64] (column `index` is written); cross_k/v
// [batch, heads, S, 64]; key_mask [batch, T] and cross_mask [batch, S] int32;
// out [batch, D]; scratch fp32 [batch, 10 D + F].
extern "C" int cxr_fused_layer_step_f32(const void* const* ptrs, int batch, int heads, int t_len,
                                        int s_len, int d_model, int d_ff, int dh, int index,
                                        float scale, float eps, void* stream) {
  return launch<float>(ptrs, batch, heads, t_len, s_len, d_model, d_ff, dh, index, scale, eps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_layer_step_bf16(const void* const* ptrs, int batch, int heads,
                                         int t_len, int s_len, int d_model, int d_ff, int dh,
                                         int index, float scale, float eps, void* stream) {
  return launch<__nv_bfloat16>(ptrs, batch, heads, t_len, s_len, d_model, d_ff, dh, index, scale,
                               eps, static_cast<cudaStream_t>(stream));
}
