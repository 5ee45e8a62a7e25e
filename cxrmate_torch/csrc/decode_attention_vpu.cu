// Decode attention from separate fp32 multiplies and adds in one fixed order.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:221
// decode_attention_rowgroup_vpu (Pallas, TPU; kernel body :189-217): the
// contract of decode_attention (decode_attention.cu) with q, K and V cast to
// fp32 and every contraction an unfused multiply followed by a reduction, no
// matrix unit. On the TPU it probed whether a kernel could reproduce the
// reduction order of the compiler's own attention bit for bit.
//
// Bound on the H100: bytes, the same as decode_attention.cu (q, the mask,
// the output, and K and V of the unmasked keys once).
//
// Design: decode_attention.cu's, from the same body (decode_split.cuh): one
// launch, a thread-block cluster of n_split <= 8 blocks of 128 threads per
// (b, h), S's 64-key tiles dealt to the blocks in turn; masked keys (mask exactly
// finfo.min) never read, which is exact (decode_split.cuh); the row max and
// the denominator exchanged through distributed shared memory, the partial
// contexts added by the ranks. What makes this a different kernel is its
// arithmetic: every product is __fmul_rn and every sum __fadd_rn (the
// intrinsics are never contracted into an fma, whatever the compiler flags),
// and the order of every sum is a function of (S, dh) alone. With
// n = decode_schedule(S, dh)[0] (ops/decode_attention.py), block c holding
// the 64-key tiles c, c + n, c + 2n, ... of S, its local key i being the key
// (c + (i / 64) n) 64 + i % 64, and in fp32 / bf16 KPW = 2 / 4 key rows a
// warp load, STEP = 4 * KPW = 8 / 16:
//
//   score[s]  the 64 products k[s][d] * q[d] are summed as 16 runs of four
//             consecutive d, each left to right ((p0 + p1) + p2) + p3, and
//             the 16 runs by a balanced binary tree over neighbours
//             (run 2i + run 2i+1, then pairs of those, ...); then
//             score = (sum * scale) + mask[s]. A key whose mask is finfo.min
//             is not computed: its score is finfo.min.
//   softmax   max over s (order-free); e[s] = expf(score[s] - max). The
//             denominator: in each block, 128 streams, stream t summing e at
//             local i = t, t + 128, ... (increasing i, from 0.0f), the 32
//             streams of a warp by a balanced tree over neighbours, the 4
//             warps left to right; then the n blocks' sums left to right
//             (block 0 first). p[s] = e[s] / denominator (__fdiv_rn), rounded to the
//             input dtype.
//   ctx[d]    in each block, the products p[s] * v[s][d] are summed over
//             STEP streams, stream j holding the local keys i = j, j + STEP,
//             ... (increasing i, from 0.0f); the KPW streams w * KPW .. w *
//             KPW + KPW - 1 of warp w by a balanced tree over neighbours; the
//             4 warps left to right; then the n blocks' partial contexts left
//             to right (block 0 first).
//
// A masked key that is skipped would have added exactly +0.0 (e = 0, p = 0,
// p * v = +-0.0), so skipping it changes no sum. Nothing in the order
// depends on B, M, the SM count or the launch, so a row's output bits do not
// depend on the batch it is in. The order differs from the earlier
// one-block-per-(b, h) kernel's (256 threads, 16 ctx streams, no split), and
// so do some bits.
#include "decode_split.cuh"

extern "C" int cxr_decode_attention_vpu_f32(const void* q, const void* k, const void* v,
                                            const void* mask, void* o, int bh, int heads, int m,
                                            int s_len, int dh, int n_split, int chunk, float scale,
                                            void* stream) {
  return cxr::split::launch<float, float, true>(
      q, k, v, nullptr, nullptr, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_vpu_bf16(const void* q, const void* k, const void* v,
                                             const void* mask, void* o, int bh, int heads, int m,
                                             int s_len, int dh, int n_split, int chunk, float scale,
                                             void* stream) {
  return cxr::split::launch<__nv_bfloat16, __nv_bfloat16, true>(
      q, k, v, nullptr, nullptr, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}
