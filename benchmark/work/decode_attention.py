"""Work of a decode-attention call (``cxrmate_torch/ops/decode_attention.py``).

Bytes: q and the output once, the additive mask once (fp32), and K and V of
the unmasked keys only: a key under finfo(float32).min gets probability
exactly 0 and cannot change the output, so a kernel need not read it. A key
costs two rows of the cache's type per head. Operations: 4 * keys * heads *
query rows * head width (scores and context)."""

# the CUDA kernel the wrapper launches, as the device trace names it
KERNEL_NAMES = ("decode_split_kernel",)


def work(q_shape, itemsize: int, mask_numel: int, keys: float):
    """(bytes, operations) of one call: q [B, H, M, Dh] of ``itemsize``
    bytes an element, ``keys`` unmasked (row, key) pairs of the [B, S] mask."""
    b, h, m, dh = q_shape
    return (2 * b * h * m * dh * itemsize + keys * h * 2 * dh * itemsize + mask_numel * 4,
            4.0 * keys * h * m * dh)
