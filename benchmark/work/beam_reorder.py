"""Work of a beam reorder of the self cache (``cxrmate_torch/ops/beam_reorder.py``).

In place over K and V [R, H, T, Dh]: a row that takes another beam's row is
read from its source and written whole; a row that keeps its own gets only
the new column (read and written), and nothing when there is no column to
write. The selection, int32 per row, is read once."""

KERNEL_NAMES = ("beam_reorder_kernel",)


def work(cache_shape, itemsize: int, moved: float, writes_column: bool) -> float:
    """Bytes of one call: ``moved`` of the R rows take another beam's row."""
    r, h, t, dh = cache_shape
    row, col = h * t * dh * itemsize, h * dh * itemsize
    kept = r - moved
    per_cache = moved * 2 * row + (kept * 2 * col if writes_column else 0)
    return 2 * per_cache + r * 4
