// Decode attention over an int8-quantised K/V cache: M query rows (1 for
// greedy, the beam count for beam search's shared cross cache) against S keys
// stored as int8 rows with one fp32 scale per key, and a [B, S] fp32 additive
// key mask, for one decode step.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:310
// decode_attention_rowgroup_q8 (Pallas, TPU; kernel body :282-306), fed by
// quantize_kv_rowwise (:259, plain tensor ops in both packages).
// Contract: scores = (q . kq) in fp32, x ks[s], then x scale, + mask; softmax
// with the row max subtracted, in fp32, NOT rounded; pv = probs x vs[s],
// rounded to q's dtype (the V scale is folded in before the one rounding);
// ctx = pv . vq accumulated in fp32 and cast to q's dtype. The int8 values are
// never multiplied by their scales: both scales fold into the [M, S] tensors,
// and int8 -> fp32 is exact. A fully masked row (mask = finfo(f32).min, not
// -inf) gives the uniform softmax.
//
// Bound on the H100: bytes. A call must read q, the mask, and of each key
// that is not masked its two int8 rows and two fp32 scales (136 bytes a key
// and head, against 256 in bf16), and write the output. The multi and
// longitudinal cross call (8 studies, S = 2,880, 15 of 40 image slots
// masked) needs 23.5 MB, 7.0 us at 3.35 TB/s.
//
// Design: decode_attention.cu's, from the same body (decode_split.cuh) with
// KV = signed char. One launch per call: a thread-block cluster of n_split
// <= 8 blocks of 128 threads per (b, h) (ops/decode_attention.py:
// decode_schedule, a function of (S, dh) alone; 768 blocks at the cross
// shapes, 7 an SM), S's 64-key tiles dealt to the blocks in turn. A key whose
// mask is exactly finfo.min reads neither its int8 rows nor its scales; a
// tile with no unmasked key is not visited (a study's empty image slots).
// An int8 key row is 64 bytes, eight lanes of 8 bytes (cp.async of 8 bytes
// into a per-lane ring of two tiles), converted to fp32 in registers. The
// K scale multiplies the dot where the score is formed; the V scale is
// loaded beside it into shared memory and multiplies the normalised prob
// before its one rounding. The exact softmax's row max and denominator are
// exchanged through distributed shared memory (the denominators added in
// rank order), and the partial contexts pushed to their owning ranks. The
// sums use fma in any order (the JAX kernel has no fixed-order contract).
// Why skipping a masked key is exact: decode_split.cuh.
#include "decode_split.cuh"

extern "C" int cxr_decode_attention_q8_f32(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* mask,
                                           void* o, int bh, int heads, int m, int s_len, int dh,
                                           int n_split, int chunk, float scale, void* stream) {
  return cxr::split::launch<float, signed char, false>(
      q, kq, vq, ks, vs, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_q8_bf16(const void* q, const void* kq, const void* ks,
                                            const void* vq, const void* vs, const void* mask,
                                            void* o, int bh, int heads, int m, int s_len, int dh,
                                            int n_split, int chunk, float scale, void* stream) {
  return cxr::split::launch<__nv_bfloat16, signed char, false>(
      q, kq, vq, ks, vs, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}
