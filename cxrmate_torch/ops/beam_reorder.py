"""In-place beam reorder + KV-column write, kernel 3 of the port.

Replaces ``cxrmate_tpu/ops/beam_reorder.py:58 beam_reorder_write``. Within each
group of ``beams`` rows (one study's beams), row j of the self-K/V cache takes
old row ``sel_local[j]`` of its group, and column ``index`` (``-1``: none)
takes the new K/V of that source row. Pure data movement, bit-exact. The CUDA
kernel (``csrc/beam_reorder.cu``) updates the cache in place; its source note
says what bounds it on the H100 and how the design meets that.

On CPU tensors :func:`beam_reorder_write` runs
:func:`beam_reorder_write_plain`; on CUDA tensors it launches the kernel or
raises. Both update ``cache_k``/``cache_v`` in place and return them.
"""

from __future__ import annotations

import ctypes

import torch

from cxrmate_torch.ops import _build

_NAME = "cxr_beam_reorder_write"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SMEM_LIMIT = 232448
_COLS = 32  # cache columns per block, as in the kernel


def _sources(sel_local: torch.Tensor, beams: int) -> torch.Tensor:
    r = sel_local.shape[0]
    base = torch.arange(r, device=sel_local.device) // beams * beams
    return base + sel_local.long()


def beam_reorder_write_plain(cache_k, cache_v, new_k, new_v, sel_local, index: int, beams: int):
    """The kernel's plain version: a gather of the source rows, the column
    write, and a copy back into the cache."""
    src = _sources(sel_local, beams)
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        out = cache.index_select(0, src)
        if index >= 0:
            out[:, :, index] = new.index_select(0, src)
        cache.copy_(out)
    return cache_k, cache_v


def beam_reorder_write(cache_k: torch.Tensor, cache_v: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, sel_local: torch.Tensor, index: int, beams: int):
    """cache_k/cache_v [R, H, T, dh] (R = groups x beams, beam-major per
    group); new_k/new_v [R, H, dh], this step's K/V per source row; sel_local
    [R] int32, the source beam (0..beams-1) within each group; ``index`` the
    column to write, -1 for none. Updates the caches in place."""
    if cache_k.device.type == "cpu":
        return beam_reorder_write_plain(cache_k, cache_v, new_k, new_v, sel_local, index, beams)
    req = _build.require
    tensors = (cache_k, cache_v, new_k, new_v, sel_local)
    req(cache_k.is_cuda and all(t.device == cache_k.device for t in tensors),
        "beam_reorder_write: all tensors must be on one CUDA device")
    req(cache_k.dim() == 4 and cache_v.shape == cache_k.shape
        and cache_v.dtype == cache_k.dtype,
        f"beam_reorder_write: caches {tuple(cache_k.shape)}, {tuple(cache_v.shape)}")
    r, h, t, dh = cache_k.shape
    req(new_k.shape == (r, h, dh) and new_v.shape == (r, h, dh)
        and new_k.dtype == cache_k.dtype and new_v.dtype == cache_k.dtype,
        f"beam_reorder_write: new K/V must be [{r}, {h}, {dh}] of {cache_k.dtype}")
    req(sel_local.dtype == torch.int32 and sel_local.shape == (r,),
        f"beam_reorder_write: sel_local must be int32 [{r}]")
    req(beams >= 1 and r % beams == 0, f"beam_reorder_write: {r} rows, {beams} beams")
    req(-1 <= index < t, f"beam_reorder_write: index {index} outside [-1, {t})")
    row_bytes = dh * cache_k.element_size()
    req(row_bytes % 16 == 0, "beam_reorder_write: dh * element size must be a multiple of 16")
    req(beams * _COLS * row_bytes <= _SMEM_LIMIT, "beam_reorder_write: too many beams")
    req(all(x.is_contiguous() for x in tensors), "beam_reorder_write: tensors must be contiguous")
    if r == 0:
        return cache_k, cache_v
    fn = _build.kernel(_NAME, _ARGTYPES)
    with torch.cuda.device(cache_k.device):
        err = fn(cache_k.data_ptr(), cache_v.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
                 sel_local.data_ptr(), int(index), r, beams, h, t, row_bytes,
                 _build.stream_of(cache_k))
    _build.check(err, _NAME)
    beam_reorder_write.launches += 1
    return cache_k, cache_v


beam_reorder_write.launches = 0
