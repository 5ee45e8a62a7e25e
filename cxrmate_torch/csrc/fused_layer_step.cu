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
// cross K/V rows the masks leave open (44 MB of cross K/V in bf16 at the fused
// path's B = 8, S = 2,880 with 15 of 40 image slots masked).
//
// Design: v2's stages in one cooperative launch (one block of 16 warps per
// SM, all co-resident), with a grid-wide sync wherever a stage needs the
// whole output of the one before, and fp32 scratch between the stages (read
// past L1, __ldcg, since other SMs wrote it). The stages are v2's own device
// code (fused_decode.cuh), with fp32 where v2 rounds and one unit in flight
// a warp in the split-K passes after the first:
//   1. fused_qkv_attn's split-K q/k/v projection; the block's first
//      (study, head)'s cached K/V asked into L2 before the sync; which
//      studies have no open cross key;
//   2. fused_qkv_attn's self-attention, one (study, head) per block, the
//      cache column written; the block's rows of Wo and Wcq asked into L2;
//   3. fused_out_ln_q's two split-K passes (Wo, sync, LayerNorm, Wcq): h1
//      and cq to scratch, fp32;
//   4. the cross-attention, each (study, head)'s S keys split into the
//      n_split parts of ops/decode_attention.py:decode_schedule(S, 64) (a
//      function of S alone; 64-key tiles dealt to the parts in turn). A
//      (study, head, part) goes to a pair of warps (w, w + 8) of a block,
//      item it to pair (it / G) % 8 of block it % G, so that a (study,
//      head)'s parts are on neighbouring blocks and every SM gets about as
//      many; the pair's warps take the part's tiles in turn. A warp lists
//      its tiles from the integer study mask, eight tiles' mask words at a
//      time (a tile with no open key is never visited, a masked key's K and
//      V rows never read), and streams the open keys' K and V rows together
//      through an online softmax: its running maximum, its sum of e = exp(s
//      - max) and its context sum e v, rescaled when the maximum grows. A
//      masked key's e is 0, as in the plain version's exact softmax, where
//      exp(finfo.min - max) is exactly 0 in fp32 (csrc/decode_split.cuh says
//      why); a study whose every key is masked (a flag per study from stage
//      1) takes every key with score 0, the uniform softmax the plain
//      version gives. The pair merges its two states in order; the part that
//      finishes its (study, head) last (a ticket: fence, then an atomic
//      count) merges the parts' states in part order, rescaled to their
//      common maximum, and writes the context, one division; the block's
//      rows of Wco and W1 asked into L2; grid sync;
//   5. fused_out_ln_ffn's three split-K passes and its last LayerNorm, one
//      row a block, into `out`.
// Eight grid syncs, as before the redesign. Every product's slices and the
// cross parts are added in a fixed order, so a row's bits depend neither on
// the card, the grid nor the batch. Every weight is read once for up to 8
// rows; more studies run the dense stages in chunks of 8. The cross exchange
// goes through scratch, not a cluster's shared memory: the card takes a
// cooperative launch with a cluster dimension, but a part's state is merged
// by a ticket, with no barrier of its own.
#include <algorithm>

#include "fused_decode.cuh"

namespace {

using namespace cxr;
using namespace cxr::fused;

constexpr int kThreads = kPassThreads;
constexpr int kWarps = kPassWarps;
constexpr int kPointers = 27;
constexpr int kQkvUnits = 4;      // units a warp has in flight in the projection, as v2's
// ... and in the other five products: one. The whole kernel's code (some 250
// KB) is larger than an SM's instruction cache, so each stage's code is
// fetched anew in every launch, and fewer unrolled units measured faster
// than v2's three (PERF.md)
constexpr int kUnits = 1;
constexpr int kPair = 2;          // warps of a cross item: a part's tiles dealt in turn
constexpr int kPairs = kWarps / kPair;
constexpr int kGroup = 2;         // tiles of a warp whose mask words it loads at once
constexpr int kXc = kDh + 2;      // floats of a pair's exchange: its context, sum, maximum
constexpr int kTile = 64;         // cross keys a tile: dealt to the parts, skipped whole
constexpr int kMaxSplit = 8;      // parts of a (study, head) at most
constexpr int kTargetChunk = 256; // keys a part aims at (ops/decode_attention.py)

// fp32 scratch, laid out by the launcher: the stages' rows ([batch, width]
// each), W2's partials, per cross item (study, head, part), rounded up to 4
// items, its maximum, its sum of e and its partial context [64], a ticket
// per (study, head) and a flag per study
struct Scratch {
  float* qkv;   // 3D
  float* ctx;   // D: the self-attention's context
  float* y1;    // D: before LayerNorm 1
  float* h1;    // D
  float* cq;    // D
  float* y2;    // D: before LayerNorm 2
  float* z;     // F
  float* p2;    // [slices(F)][kRows][D]
  float* cctx;  // D: the cross-attention's context
  float *pmax, *psum, *pctx;
  unsigned* cnt;  // per (study, head): its parts done
  int* dark;      // per study: no open cross key
};

template <typename T>
struct StepArgs {
  const T *hidden, *wqkv, *bqkv;
  const T *wo, *bo, *g1, *be1, *wcq, *bcq;                        // self out, LN 1, cross q
  const T *wco, *bco, *g2, *be2, *w1, *b1, *w2, *b2, *g3, *be3;   // cross out, LN 2, FFN, LN 3
  T *cache_k, *cache_v;
  const T *cross_k, *cross_v;
  const int *key_mask, *cross_mask;
  T* out;
  Scratch s;
  int batch, heads, t_len, s_len, d_model, d_ff, index, n_split;
  float scale, eps;
};

// Shared memory (floats): the largest of a split-K pass's 8 input rows and
// their partials, the self-attention and the FFN's 8 rows of h2 beside 8 of
// its widest input; the cross stage's exchange (a few KB) fits in any.
inline size_t smem_floats(int d_model, int d_ff, int t_len) {
  const size_t dense = (size_t)2 * kRows * d_model;
  const size_t self_attn = 3 * kDh + attend_floats(t_len, kWarps);
  const size_t ffn = (size_t)kRows * (d_model + (d_ff > d_model ? d_ff : d_model));
  return std::max(std::max(dense, self_attn), ffn);
}

// How a 64-wide K/V row of T spreads over a warp: a lane reads 16 bytes.
template <typename T> struct KvRow {
  static constexpr int kVec = 16 / sizeof(T);  // values a lane: 8 bf16, 4 fp32
  static constexpr int kLpk = kDh / kVec;      // lanes a row: 8, 16
  static constexpr int kKpw = 32 / kLpk;       // rows a warp load: 4, 2
  static constexpr int kLoads = kTile / kKpw;  // loads a lane a tile: 16, 32
  static constexpr int kFlight = 4;            // of K's and V's in flight at once
};

__device__ __forceinline__ bool has(uint2 w, int i) {
  return ((i < 32 ? w.x : w.y) >> (i & 31)) & 1u;
}

// A warp's tiles of a cross item come in groups of kGroup: tile g of the
// group that starts at t0 is t0 + g step. The open keys of each (or with
// `all`, every key below S) as 64 bits (key t 64 + i is bit i) -> bits, the
// warp's kGroup slots of shared memory: one round trip for the group's mask
// words.
__device__ __forceinline__ void group_bits(const int* mrow, int t0, int step, int tiles,
                                           int s_len, bool all, uint2* bits) {
  const int lane = threadIdx.x & 31;
  int m[2 * kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int t = t0 + g * step, k0 = t * kTile + lane, k1 = k0 + 32;
    m[2 * g] = t < tiles && k0 < s_len ? (all ? 1 : __ldg(mrow + k0)) : 0;
    m[2 * g + 1] = t < tiles && k1 < s_len ? (all ? 1 : __ldg(mrow + k1)) : 0;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const uint2 w = make_uint2(__ballot_sync(0xffffffffu, m[2 * g] != 0),
                               __ballot_sync(0xffffffffu, m[2 * g + 1] != 0));
    if (lane == 0) bits[g] = w;
  }
  __syncwarp();
}

// The two warps of cross pair `pair` (warps pair and pair + 8) meet.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pair), "r"(2 * 32) : "memory");
}

// Cross item it = (unit u = study b, head h; part p), warp `sub` of its pair,
// in one pass: the part's tiles j = sub, sub + 2, ... (tile p + j n_split of
// S), per group of them their mask words, then per batch of key rows of a
// tile with an open key their K and V rows together: the scores (x scale,
// fp32), an online softmax (the warp's running maximum m, sum l and context
// sum e v, rescaled by exp(m_old - m) when m grows) over the open keys; a
// fully masked study (its flag from stage 1) takes every key with score 0,
// the uniform softmax the plain version gives. The pair's two states are
// merged in order (xc: the pair's 66 floats of shared memory) -> pmax, psum,
// pctx. The part that finishes its (study, head) last (a ticket: fence, then
// an atomic count) merges the parts' states in part order and writes the
// context, one division.
template <typename T>
__device__ __forceinline__ void cross_part(const StepArgs<T>& a, int it, int pair, int sub,
                                           float* xc, uint2* bits) {
  using R = KvRow<T>;
  const int lane = threadIdx.x & 31;
  const int u = it / a.n_split, p = it - u * a.n_split, b = u / a.heads, h = u - b * a.heads;
  const int li = lane % R::kLpk, row = lane / R::kLpk;
  const int tiles = (a.s_len + kTile - 1) / kTile, step = kPair * a.n_split;
  const int* mrow = a.cross_mask + (size_t)b * a.s_len;
  const size_t base = (size_t)u * a.s_len * R::kLpk;  // in 16-byte vectors
  const uint4* k4 = reinterpret_cast<const uint4*>(a.cross_k) + base;
  const uint4* v4 = reinterpret_cast<const uint4*>(a.cross_v) + base;
  const bool dark = __ldcg(a.s.dark + b) != 0;
  float qf[R::kVec];
#pragma unroll
  for (int e = 0; e < R::kVec; ++e)
    qf[e] = __ldcg(a.s.cq + (size_t)b * a.d_model + h * kDh + li * R::kVec + e);
  float m = kNeg, l = 0.f, cacc[R::kVec];
#pragma unroll
  for (int e = 0; e < R::kVec; ++e) cacc[e] = 0.f;
  for (int t0 = p + sub * a.n_split; t0 < tiles; t0 += step * kGroup) {
    group_bits(mrow, t0, step, tiles, a.s_len, dark, bits);
    for (int g = 0; g < kGroup; ++g) {
      const uint2 w = bits[g];
      if (!(w.x | w.y)) continue;  // no open key, or past the last tile
      const size_t t = (size_t)(t0 + g * step) * kTile;
      for (int l0 = 0; l0 < R::kLoads; l0 += R::kFlight) {
        uint4 kb[R::kFlight], vb[R::kFlight];
#pragma unroll
        for (int i = 0; i < R::kFlight; ++i) {
          const int kt = (l0 + i) * R::kKpw + row;
          const bool take = has(w, kt);
          kb[i] = take && !dark ? __ldg(k4 + (t + kt) * R::kLpk + li) : make_uint4(0, 0, 0, 0);
          vb[i] = take ? __ldg(v4 + (t + kt) * R::kLpk + li) : make_uint4(0, 0, 0, 0);
        }
        float sc[R::kFlight], top = kNeg;
#pragma unroll
        for (int i = 0; i < R::kFlight; ++i) {
          float kf[R::kVec];
          unpack16<T>(kb[i], kf);
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < R::kVec; ++e) acc = fmaf(qf[e], kf[e], acc);
#pragma unroll
          for (int off = R::kLpk / 2; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          sc[i] = has(w, (l0 + i) * R::kKpw + row) ? (dark ? 0.f : acc * a.scale) : kNeg;
          top = fmaxf(top, sc[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
        const float mn = fmaxf(m, top), alpha = expf(m - mn);
        m = mn;
        l *= alpha;
#pragma unroll
        for (int e = 0; e < R::kVec; ++e) cacc[e] *= alpha;
#pragma unroll
        for (int i = 0; i < R::kFlight; ++i) {
          const float ex = sc[i] > kNeg ? expf(sc[i] - m) : 0.f;
          float vf[R::kVec];
          unpack16<T>(vb[i], vf);
#pragma unroll
          for (int e = 0; e < R::kVec; ++e) cacc[e] = fmaf(ex, vf[e], cacc[e]);
          if (li == 0) l += ex;
        }
      }
    }
    __syncwarp();  // bits is read before the next group writes it
  }
  // the warp's key rows (lanes with the same li), then the rows' sums
#pragma unroll
  for (int e = 0; e < R::kVec; ++e)
#pragma unroll
    for (int off = R::kLpk; off < 32; off <<= 1)
      cacc[e] += __shfl_xor_sync(0xffffffffu, cacc[e], off);
  l = warp_sum(l);
  if (sub == 1) {
    if (row == 0) {
#pragma unroll
      for (int e = 0; e < R::kVec; ++e) xc[li * R::kVec + e] = cacc[e];
    }
    if (lane == 0) {
      xc[kDh] = l;
      xc[kDh + 1] = m;
    }
  }
  pair_sync(pair);
  if (sub == 0) {
    const float m1 = xc[kDh + 1], mp = fmaxf(m, m1);
    const float a0 = expf(m - mp), a1 = expf(m1 - mp);
    if (row == 0) {
      float* out = a.s.pctx + (size_t)it * kDh + li * R::kVec;
#pragma unroll
      for (int e = 0; e < R::kVec; ++e) out[e] = cacc[e] * a0 + xc[li * R::kVec + e] * a1;
    }
    if (lane == 0) {
      a.s.psum[it] = l * a0 + xc[kDh] * a1;
      a.s.pmax[it] = mp;
    }
    // the part that finishes its (study, head) last merges the parts
    __threadfence();
    unsigned ticket = 0;
    if (lane == 0) ticket = atomicAdd(a.s.cnt + u, 1u);
    if (__shfl_sync(0xffffffffu, ticket, 0) == (unsigned)a.n_split - 1) {
      __threadfence();
      const float* pc = a.s.pctx + (size_t)u * a.n_split * kDh;
      const float* ps = a.s.psum + (size_t)u * a.n_split;
      const float* pm = a.s.pmax + (size_t)u * a.n_split;
      float top = kNeg;
      for (int q = 0; q < a.n_split; ++q) top = fmaxf(top, __ldcg(pm + q));
      float c0 = 0.f, c1 = 0.f, sum = 0.f;
      for (int q = 0; q < a.n_split; ++q) {
        const float f = expf(__ldcg(pm + q) - top);
        c0 += __ldcg(pc + q * kDh + lane) * f;
        c1 += __ldcg(pc + q * kDh + 32 + lane) * f;
        sum += __ldcg(ps + q) * f;
      }
      float* o = a.s.cctx + (size_t)u * kDh;  // [B, D]: u = b H + h
      o[lane] = c0 / sum;
      o[32 + lane] = c1 / sum;
    }
  }
  pair_sync(pair);  // xc is read before the pair's next item writes it
}

template <typename T>
__global__ void __launch_bounds__(kThreads) layer_step_kernel(const StepArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();

  // 1. q, k_new, v_new of every row; the cross tickets zeroed
  qkv_projection<T, kQkvUnits>(a.hidden, a.wqkv, a.bqkv, a.s.qkv, a.batch, a.d_model, smem);
  prefetch_self_unit(a.cache_k, a.cache_v, a.key_mask, a.batch * a.heads, a.heads, a.t_len,
                     a.index);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.batch * a.heads; i += kThreads) a.s.cnt[i] = 0;
  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {  // which studies are fully masked
    int open = 0;
    const int* mrow = a.cross_mask + (size_t)b * a.s_len;
    for (int i = threadIdx.x; i < a.s_len; i += kThreads) open |= __ldg(mrow + i) != 0;
    open = __syncthreads_or(open);
    if (threadIdx.x == 0) a.s.dark[b] = !open;
  }
  grid.sync();

  // 2. self-attention, one (study, head) per block in turn; then its column
  self_attention<T, float>(a.s.qkv, a.cache_k, a.cache_v, a.key_mask, a.s.ctx, a.batch, a.heads,
                           a.t_len, a.d_model, a.index, a.scale, smem, red);
  prefetch_rows(a.wo, block_share(a.d_model), a.d_model);
  prefetch_rows(a.wcq, block_share(a.d_model), a.d_model);
  grid.sync();

  // 3. h1 = LayerNorm(ctx Wo^T + bo + hidden); cq = h1 Wcq^T + bcq
  for (int b0 = 0; b0 < a.batch; b0 += kRows) {
    const int rows = min(kRows, a.batch - b0);
    const size_t off = (size_t)b0 * a.d_model;
    load_scratch_rows<T>(a.s.ctx + off, rows, a.d_model, smem);
    __syncthreads();
    out_ln_q_passes<T, float, kUnits>(grid, smem, rows, off, a.d_model, a.hidden, a.wo, a.bo,
                                      a.g1, a.be1, a.wcq, a.bcq, a.eps, a.s.y1, a.s.h1, a.s.cq);
    __syncthreads();
  }
  grid.sync();

  // 4. cross-attention, a (study, head, part) a pair of warps; per (study,
  // head), the context
  {
    const int pair = (threadIdx.x >> 5) % kPairs, sub = (threadIdx.x >> 5) / kPairs;
    float* xc = smem + pair * kXc;  // the pair's exchange
    uint2* bits = reinterpret_cast<uint2*>(smem + kPairs * kXc) + (threadIdx.x >> 5) * kGroup;
    const int items = a.batch * a.heads * a.n_split;
    for (int it = pair * gridDim.x + blockIdx.x; it < items; it += kPairs * gridDim.x)
      cross_part(a, it, pair, sub, xc, bits);
  }
  prefetch_rows(a.wco, block_share(a.d_model), a.d_model);
  prefetch_rows(a.w1, block_share(a.d_ff), a.d_model);
  grid.sync();

  // 5. h2 = LayerNorm(cctx Wco^T + bco + h1); out = LayerNorm(gelu(h2 W1^T +
  // b1) W2^T + b2 + h2)
  for (int b0 = 0; b0 < a.batch; b0 += kRows) {
    const int rows = min(kRows, a.batch - b0), d = a.d_model;
    const size_t off = (size_t)b0 * d, off_ff = (size_t)b0 * a.d_ff;
    float* hs = smem;            // [kRows][D]: h2, the FFN's input and residual
    float* xs = hs + kRows * d;  // [kRows][max(D, F)]: a pass's input rows
    load_scratch_rows<T>(a.s.cctx + off, rows, d, xs);
    __syncthreads();
    const float* h1 = a.s.h1 + off;
    out_ln_ffn_passes<T, kUnits>(
        grid, hs, xs, rows, off, off_ff, d, a.d_ff,
        [h1, d](int o, int b) { return __ldcg(h1 + (size_t)b * d + o); }, a.wco, a.bco, a.g2,
        a.be2, a.w1, a.b1, a.w2, a.b2, a.g3, a.be3, a.eps, a.s.y2, a.s.z, a.s.p2, a.out);
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
  float* scratch = static_cast<float*>(const_cast<void*>(ptrs[p++]));
  if (p != kPointers) return cudaErrorInvalidValue;
  a.batch = batch;
  a.heads = heads;
  a.t_len = t_len;
  a.s_len = s_len;
  a.d_model = d_model;
  a.d_ff = d_ff;
  a.index = index;
  // ops/decode_attention.py:decode_schedule(S, 64): parts of about
  // kTargetChunk keys, at most kMaxSplit
  a.n_split = std::min(kMaxSplit, (s_len + kTargetChunk - 1) / kTargetChunk);
  const size_t bd = (size_t)batch * d_model;
  const size_t items = ((size_t)batch * heads * a.n_split + 3) / 4 * 4;
  a.s.qkv = scratch;
  a.s.ctx = a.s.qkv + 3 * bd;
  a.s.y1 = a.s.ctx + bd;
  a.s.h1 = a.s.y1 + bd;
  a.s.cq = a.s.h1 + bd;
  a.s.y2 = a.s.cq + bd;
  a.s.z = a.s.y2 + bd;
  a.s.p2 = a.s.z + (size_t)batch * d_ff;
  a.s.cctx = a.s.p2 + (size_t)slices<T>(d_ff) * kRows * d_model;
  a.s.pmax = a.s.cctx + bd;
  a.s.psum = a.s.pmax + items;
  a.s.pctx = a.s.psum + items;
  a.s.cnt = reinterpret_cast<unsigned*>(a.s.pctx + items * kDh);
  a.s.dark = reinterpret_cast<int*>(a.s.cnt + (size_t)batch * heads);
  a.scale = scale;
  a.eps = eps;
  const size_t smem = sizeof(float) * smem_floats(d_model, d_ff, t_len);
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
// out [batch, D]; scratch fp32 [batch (9 D + F + heads + 1) + slices(F) 8 D
// + 66 I], I = batch heads n_split rounded up to a multiple of 4 (n_split:
// decode_schedule(S, 64)), slices(n) = ceil(n / (16 / sizeof(T)) / 32).
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
