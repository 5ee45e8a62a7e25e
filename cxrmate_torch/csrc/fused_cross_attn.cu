// Fused step, kernel 3 of 4: cross-attention of one query per study over the
// encoder K/V.
//
// Replaces cxrmate_tpu/ops/fused_decode.py:291 _cross_attn_kernel_v2 (the
// third pallas_call of :366 fused_layer_step_v2). Contract, fp32 inside:
// scores = cq . K x scale + (1 - cross_mask) x finfo(f32).min; softmax; the
// probabilities stay fp32 (decode_attention rounds them to the input dtype,
// this body does not); ctx = probs . V, rounded to the hidden dtype. Query and
// context are [B, D] with the heads side by side, as the neighbouring dense
// kernels write and read them: no transposes between the four kernels. The
// integer [B, S] study mask is shared by the heads. A fully masked study gets
// the uniform softmax over all S keys, as the plain version gives it.
//
// Bound on the H100: bytes: the K and V rows of the keys that are not masked
// (2 B H S dh elements at most, 70.8 MB in bf16 at B = 8, S = 2,880; 44 MB
// with the fused path's 15 of 40 image slots masked, 13.2 us at 3.35 TB/s).
//
// Design: decode_attention's, from the same body (decode_split.cuh) under its
// Fused contract, M = 1: one launch, a thread-block cluster per (study, head)
// of ops/decode_attention.py:decode_schedule(S, 64) blocks of 128 threads (8
// at S = 2,880, 768 blocks in all, 7 an SM, all resident at once); S's 64-key
// tiles dealt to the blocks in turn, so a study's open image slots spread
// evenly over them; a key whose mask is 0 has its K and V rows never read, a
// tile with no open key is not visited (the all-zero image slots); the exact
// softmax's max and denominator exchanged through distributed shared memory,
// the partial contexts added by the ranks in rank order. The mask entries
// are read four a thread, in one 16-byte load where the mask's rows are
// 16-byte aligned. S is limited by one block's shared memory
// (ops/decode_attention.py:max_keys at M = 1). A refused cluster launch
// returns its error; the wrapper raises.
#include "decode_split.cuh"

// Shapes: cq, ctx [B, D] = [B, H, 1, 64]; k, v [B, H, S, 64]; mask [B, S]
// int32; bh = B H; n_split and chunk from decode_schedule(S, 64).
extern "C" int cxr_fused_cross_attn_f32(const void* cq, const void* k, const void* v,
                                        const void* mask, void* ctx, int bh, int heads,
                                        int s_len, int dh, int n_split, int chunk, float scale,
                                        void* stream) {
  return cxr::split::launch<float, float, false, cxr::split::Fused>(
      cq, k, v, nullptr, nullptr, mask, ctx, bh, heads, 1, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}

extern "C" int cxr_fused_cross_attn_bf16(const void* cq, const void* k, const void* v,
                                         const void* mask, void* ctx, int bh, int heads,
                                         int s_len, int dh, int n_split, int chunk, float scale,
                                         void* stream) {
  return cxr::split::launch<__nv_bfloat16, __nv_bfloat16, false, cxr::split::Fused>(
      cq, k, v, nullptr, nullptr, mask, ctx, bh, heads, 1, s_len, dh, n_split, chunk, scale,
      static_cast<cudaStream_t>(stream));
}
