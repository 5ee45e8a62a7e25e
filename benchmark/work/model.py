"""Model operations of CXRMate (the products of its matrix multiplications
and convolutions, 2 per multiply-add), from a configuration's sizes and the
shapes of the work. The count is the model's, whatever runs it: image slots
that are padding, prompt columns that are padding and the logits of prompt
columns that no token reads are not counted."""

from __future__ import annotations


def _out(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


def cvt_image(enc: dict, image_size: int) -> float:
    """One image through CvT and the projection head."""
    flops, side, c_in = 0.0, image_size, enc["num_channels"]
    tokens = 0
    for s, c in enumerate(enc["embed_dim"]):
        k = enc["patch_sizes"][s]
        side = _out(side, k, enc["patch_stride"][s], enc["patch_padding"][s])
        grid = side * side
        flops += 2.0 * c_in * k * k * c * grid
        cls = 1 if enc["cls_token"][s] else 0
        kq = enc["kernel_qkv"][s]
        side_q = _out(side, kq, enc["stride_q"][s], enc["padding_q"][s])
        side_kv = _out(side, kq, enc["stride_kv"][s], enc["padding_kv"][s])
        tq, tk = side_q * side_q + cls, side_kv * side_kv + cls
        hidden = int(c * enc["mlp_ratio"][s])
        layer = (2.0 * kq * kq * c * (side_q * side_q + 2 * side_kv * side_kv)  # depthwise
                 + 2.0 * c * c * (tq + 2 * tk)  # q, k, v
                 + 4.0 * c * tq * tk  # scores and context
                 + 2.0 * c * c * tq  # output
                 + 4.0 * c * hidden * tq)  # MLP
        flops += enc["depth"][s] * layer
        c_in, tokens = c, grid
    return flops + 2.0 * enc["embed_dim"][-1] * enc["projection_size"] * tokens


def decoder_token(dec: dict, lora, self_keys: float, cross_keys: float,
                  logits: bool = True) -> float:
    """One query row through the decoder: every layer's projections, its
    attention over ``self_keys`` and ``cross_keys``, its MLP, and the LM head
    (``logits``). The cross keys' K/V projections are per study
    (:func:`cross_kv`)."""
    d, ff = dec["hidden_size"], dec["intermediate_size"]
    per_layer = (2.0 * 4 * d * d + 4.0 * d * self_keys  # self: q, k, v, out; attention
                 + 2.0 * 2 * d * d + 4.0 * d * cross_keys  # cross: q, out; attention
                 + 4.0 * d * ff)
    if lora:
        per_layer += 2 * 4.0 * d * lora["r"]  # q and k: x A^T, then B
    head = 2.0 * d * d + 2.0 * d * dec["vocab_size"] if logits else 0.0
    return dec["num_hidden_layers"] * per_layer + head


def cross_kv(dec: dict, enc_width: int, cross_keys: float) -> float:
    """The cross-attention K and V of a study's real image tokens, every layer."""
    return dec["num_hidden_layers"] * 2 * 2.0 * enc_width * dec["hidden_size"] * cross_keys


def served_batch(cfg: dict, tokens_per_image: int, images, prompt_lengths, beams: int,
                 steps: int) -> float:
    """A served batch: each study's real images encoded, its real prompt
    tokens prefilled (one column's logits read), then ``steps`` decode steps
    of ``beams`` rows each; a row's query at step s attends to the study's
    real prompt tokens (at least its [BOS]) and the s + 1 tokens decoded so
    far."""
    dec, lora = cfg["decoder"], cfg.get("lora")
    enc_width = cfg["encoder"]["projection_size"]
    flops = sum(images) * cvt_image(cfg["encoder"], cfg["image_size"])
    for n_img, p in zip(images, prompt_lengths):
        cross = n_img * tokens_per_image
        p = max(p, 1)
        flops += cross_kv(dec, enc_width, cross)
        flops += sum(decoder_token(dec, lora, j + 1, cross, logits=False) for j in range(p))
        flops += 2.0 * dec["hidden_size"] ** 2 + 2.0 * dec["hidden_size"] * dec["vocab_size"]
        flops += beams * sum(decoder_token(dec, lora, p + s + 1, cross) for s in range(steps))
    return flops
