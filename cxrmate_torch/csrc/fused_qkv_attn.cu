// Fused step, kernel 1 of 4: the self-attention half of one decoder layer for
// one new token per study.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:251 _qkv_attn_kernel_v2 (the first
// pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside: q, k_new,
// v_new = hidden . W^T + b per head; scores of the T cached keys, x scale,
// masked by key_mask * (col < index), and of the new token's own unrounded
// k_new as one more column, masked by key_mask[:, index]; softmax over the
// T + 1 columns; ctx = probs . V + p_new * v_new (unrounded), rounded to the
// hidden dtype. The Pallas body returns k_new and v_new for the caller to
// insert; here the kernel itself writes them, rounded to the cache dtype, into
// column `index` of the cache once the head's reads are done.
//
// Bound on the H100: bytes. The q/k/v weights (3 D^2 elements, 3.5 MB in bf16
// at D = 768) are read once for all rows, the self cache up to 2 B H T dh
// elements (only the columns below `index` that are not masked).
//
// Design: one cooperative launch, one block of 16 warps per SM, two stages
// with a grid-wide sync between.
//   Stage 1 is a split-K pass (fused_decode.cuh: qkv_projection, shared with
//     v1's fused_layer_step.cu, on split_pass and block_outputs)
//     over the concatenated [3D, D] weight (the port's layout: nn.Linear's
//     [out, in] rows, q then k then v): block b owns the outputs [3D b / G,
//     3D (b + 1) / G), whose 512-byte K-slices (3 a row in bf16, 6 in fp32
//     at D = 768) its warps share in contiguous runs; the slices' partials are
//     reduced through shared memory in slice order, the bias added, the fp32
//     results written to scratch. Every warp of the grid has a few units, and
//     a row's q, k and v (so its cache column) do not depend on the card or
//     the batch. A warp has the weights of all its (up to 4) units in flight
//     at once. Each block asks L2 for its rows of the weight
//     (cp.async.bulk.prefetch.L2) once hidden's loads are on their way. More
//     than 8 studies run stage 1 in chunks of 8, which find the weight in L2.
//   Stage 2 gives each (study, head) to a block: the attend routine of
//     fused_decode.cuh over the columns below `index`, the new token as the
//     extra column. Before the grid sync each block asks L2 for its first
//     unit's cached K and V columns and L1 for its mask row, so that stage 2
//     finds them on chip.
#include "fused_decode.cuh"

namespace {

using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = kPassThreads;
constexpr int kWarps = kThreads / 32;
// units whose weights a warp has in flight: a block's 3.4 a warp at D = 768
// in bf16 (18 outputs x 3 slices over 16 warps) in one round
constexpr int kUnits = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_attn_kernel(const T* __restrict__ hidden, const T* __restrict__ wqkv,
                const T* __restrict__ bqkv, T* cache_k, T* cache_v, const int* __restrict__ key_mask,
                T* __restrict__ ctx, float* qkv, int batch, int heads, int t_len, int d_model,
                int index, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();

  // stage 1: q, k_new, v_new of every row, fp32, to scratch [batch, 3D]
  qkv_projection<T, kUnits>(hidden, wqkv, bqkv, qkv, batch, d_model, smem);
  prefetch_self_unit(cache_k, cache_v, key_mask, batch * heads, heads, t_len, index);
  grid.sync();

  // stage 2: one (study, head) per block in turn
  self_attention<T, T>(qkv, cache_k, cache_v, key_mask, ctx, batch, heads, t_len, d_model, index,
                       scale, smem, red);
}

template <typename T>
cudaError_t launch(const void* hidden, const void* wqkv, const void* bqkv, void* cache_k,
                   void* cache_v, const void* key_mask, void* ctx, void* scratch, int batch,
                   int heads, int t_len, int d_model, int dh, int index, float scale,
                   cudaStream_t stream) {
  if (dh != kDh || d_model != heads * dh || d_model % 8 != 0 || index < 0 || index >= t_len)
    return cudaErrorInvalidValue;
  const size_t dense = (size_t)2 * kRows * d_model;  // the rows, then the slices' partials
  const size_t attn = 3 * kDh + attend_floats(t_len, kWarps);
  const size_t smem = sizeof(float) * (dense > attn ? dense : attn);
  const void* fn = reinterpret_cast<const void*>(&qkv_attn_kernel<T>);
  static int grid = 0;
  static size_t grid_smem = 0;
  if (grid == 0 || smem != grid_smem) {
    const cudaError_t err = cooperative_grid(fn, kThreads, smem, &grid);
    if (err != cudaSuccess) return err;
    grid_smem = smem;
  }
  const T* a_hidden = static_cast<const T*>(hidden);
  const T* a_wqkv = static_cast<const T*>(wqkv);
  const T* a_bqkv = static_cast<const T*>(bqkv);
  T* a_ck = static_cast<T*>(cache_k);
  T* a_cv = static_cast<T*>(cache_v);
  const int* a_mask = static_cast<const int*>(key_mask);
  T* a_ctx = static_cast<T*>(ctx);
  float* a_scratch = static_cast<float*>(scratch);
  void* args[] = {&a_hidden, &a_wqkv, &a_bqkv, &a_ck, &a_cv, &a_mask, &a_ctx, &a_scratch,
                  &batch, &heads, &t_len, &d_model, &index, &scale};
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, smem, stream);
}

}  // namespace

// Shapes: hidden [batch, D], wqkv [3D, D], bqkv [3D], cache_k/v
// [batch, heads, T, 64] (column `index` is written), key_mask [batch, T] int32,
// ctx [batch, D] (out), scratch fp32 [batch, 3D].
extern "C" int cxr_fused_qkv_attn_f32(const void* hidden, const void* wqkv, const void* bqkv,
                                      void* cache_k, void* cache_v, const void* key_mask,
                                      void* ctx, void* scratch, int batch, int heads, int t_len,
                                      int d_model, int dh, int index, float scale, void* stream) {
  return launch<float>(hidden, wqkv, bqkv, cache_k, cache_v, key_mask, ctx, scratch, batch,
                       heads, t_len, d_model, dh, index, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_qkv_attn_bf16(const void* hidden, const void* wqkv, const void* bqkv,
                                       void* cache_k, void* cache_v, const void* key_mask,
                                       void* ctx, void* scratch, int batch, int heads, int t_len,
                                       int d_model, int dh, int index, float scale, void* stream) {
  return launch<__nv_bfloat16>(hidden, wqkv, bqkv, cache_k, cache_v, key_mask, ctx, scratch,
                               batch, heads, t_len, d_model, dh, index, scale,
                               static_cast<cudaStream_t>(stream));
}
