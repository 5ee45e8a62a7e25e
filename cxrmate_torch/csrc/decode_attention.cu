// Decode attention: M query rows (1 for greedy, the beam count for beam
// search's shared cross cache) against a cached K/V of S keys with a [B, S]
// fp32 additive key mask, for one decode step.
//
// Replaces cxrmate_tpu/ops/decode_attention.py:50 decode_attention (Pallas,
// TPU) and its blockings :98 decode_attention_rowgrid and :149
// decode_attention_rowgroup, which compute the same function.
// Contract (decode_attention.py:31-46, HF eager order): scores = q.k in fp32,
// x scale, + mask; softmax with the row max subtracted, in fp32; the probs are
// rounded to the input dtype before P.V; the context accumulates in fp32 and
// is cast to the input dtype. A fully masked row (mask = finfo(f32).min, not
// -inf) gives the uniform softmax, as the plain path does.
//
// Bound on the H100: bytes. A call must read q, the mask, and K and V of the
// keys that are not masked, and write the output: 2 * dh bytes of each
// dtype per unmasked key and head, 4 * M * dh flops. The multi cross call
// (8 studies, S = 2,880, 15 of 40 image slots masked) needs 44 MB in bf16,
// 13 us at 3.35 TB/s; the self calls need a few MB.
//
// Design (decode_split.cuh, shared with decode_attention_vpu.cu):
//   Grid and cluster: one launch of n_split * B * H blocks of 128 threads, a
//     cluster of n_split <= 8 blocks per (b, h); S's 64-key tiles are dealt
//     to the blocks in turn, so a row's unmasked keys (a few contiguous
//     ranges) spread evenly over them (n_split and the keys a block holds
//     are ops/decode_attention.py:decode_schedule's, a function of (S, dh)
//     alone: 8 blocks of up to 384 keys at S = 2,880, one of 256 at S =
//     256). So the 96 (b, h) of a cross call put 768 blocks on the 132 SMs,
//     not 96, all resident at once (7 an SM).
//   Masked keys are never read: a key whose mask is finfo.min gets the score
//     finfo.min without a K load, and p = +0.0 without a V load; a 64-key
//     tile with no unmasked key is not visited (the cache's unwritten tail,
//     the prompt's pads, a study's empty image slots).
//   The exact softmax across the cluster: each block keeps its keys'
//     [M, keys] scores in shared memory; the row max and then the
//     denominator are exchanged through distributed shared memory
//     (cluster.sync + map_shared_rank), the denominators added in rank order
//     so every block holds the same one; each block rounds its probs to the
//     input dtype and forms its partial [M, 64] context; the ranks then add
//     the partial contexts in rank order, each writing a slice of the output.
//     The scores never leave the SM, and the call stays one launch.
//   Loads: cp.async of 16 bytes a lane, 8 lanes a bf16 key row, 16 an fp32
//     one, through a ring of two key tiles in shared memory that K and then V
//     stream through, so the first tiles of V are in flight while the softmax
//     is exchanged.
// Why skipping a masked key is exact: decode_split.cuh. The sums run in a
// fixed order (a row's bits do not depend on its batch), with fma: any order
// is within the contract's tolerance, and the rounding point of the probs is
// kept.
#include "decode_split.cuh"

extern "C" int cxr_decode_attention_f32(const void* q, const void* k, const void* v,
                                        const void* mask, void* o, int bh, int heads, int m,
                                        int s_len, int dh, int n_split, int chunk, float scale,
                                        void* stream) {
  return cxr::split::launch<float, float, false>(
      q, k, v, nullptr, nullptr, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_decode_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* mask, void* o, int bh, int heads, int m,
                                         int s_len, int dh, int n_split, int chunk, float scale,
                                         void* stream) {
  return cxr::split::launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, v, nullptr, nullptr, mask, o, bh, heads, m, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}
