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
//   Stage 1 is a split-K pass (fused_decode.cuh: split_pass, block_outputs)
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

namespace cg = cooperative_groups;
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
  const int d3 = 3 * d_model, g = gridDim.x, blk = blockIdx.x;
  const int lo = (int)((long)d3 * blk / g), hi = (int)((long)d3 * (blk + 1) / g);

  // stage 1: q, k_new, v_new of every row, fp32, to scratch [batch, 3D]; the
  // slices' partials after the rows in shared memory. The block's rows of
  // Wqkv are asked into L2 once the first rows of hidden are on their way
  // (asked before them, they delay hidden's loads behind them)
  for (int b0 = 0; b0 < batch; b0 += kRows) {
    const int rows = min(kRows, batch - b0);
    load_rows<T>(hidden + (size_t)b0 * d_model, rows, d_model, smem, [&] {
      if (b0 == 0)
        prefetch_range(wqkv + (size_t)lo * d_model, sizeof(T) * (size_t)(hi - lo) * d_model);
    });
    __syncthreads();
    block_outputs<T, kUnits>(
        smem, d_model, wqkv, lo, hi, rows, smem + kRows * d_model,
        d_model / slices<T>(d_model),
        [&](int o, int) { return make_float2(to_float(bqkv[o]), 0.f); },
        [&](int o, int b, float y, float2 a) { qkv[(size_t)(b0 + b) * d3 + o] = y + a.x; });
  }
  // the block's first (study, head) while the grid syncs: its cached K and V
  // columns below `index` to L2, its mask row to L1
  if (blk < batch * heads) {
    const size_t base = (size_t)blk * t_len * kDh, cols = sizeof(T) * (size_t)index * kDh;
    prefetch_range(cache_k + base, cols);
    prefetch_range(cache_v + base, cols);
    prefetch_l1(key_mask + (size_t)(blk / heads) * t_len, t_len);
  }
  grid.sync();

  // stage 2: one (study, head) per block in turn
  float* qs = smem;       // [kDh]
  float* kn = qs + kDh;   // [kDh]
  float* vn = kn + kDh;   // [kDh]
  float* sc = vn + kDh;   // attend_floats(t_len, kWarps)
  for (int unit = blockIdx.x; unit < batch * heads; unit += gridDim.x) {
    const int b = unit / heads, h = unit - b * heads;
    const float* row = qkv + (size_t)b * d3 + h * kDh;
    for (int i = threadIdx.x; i < 3 * kDh; i += kThreads)
      qs[i] = __ldcg(row + (i / kDh) * d_model + (i % kDh));
    __syncthreads();
    const size_t base = (size_t)unit * t_len * kDh;
    const int* mask = key_mask + (size_t)b * t_len;
    attend<T, kWarps>(qs, cache_k + base, cache_v + base, mask, t_len, index, true, kn, vn,
                      mask[index] != 0, scale, sc, red, ctx + (size_t)b * d_model + h * kDh);
    // the head's reads of the cache are done: insert the new column
    for (int i = threadIdx.x; i < kDh; i += kThreads) {
      cache_k[base + (size_t)index * kDh + i] = from_float<T>(kn[i]);
      cache_v[base + (size_t)index * kDh + i] = from_float<T>(vn[i]);
    }
    __syncthreads();
  }
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
