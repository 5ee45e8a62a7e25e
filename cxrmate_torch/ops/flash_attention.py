"""CvT stage attention: flash (online-softmax) attention, kernel 1 of the port.

Replaces ``cxrmate_tpu/ops/flash_attention.py:60 flash_attention``. The CUDA
kernel (``csrc/flash_attention.cu``) streams K/V tiles through shared memory
with an online softmax and never writes the [Lq, Lk] score matrix; the source
note there says what bounds it on the H100 and how the design meets that.

On a CPU tensor :func:`flash_attention` runs :func:`flash_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cxrmate_torch.ops import _build

_C = {torch.float32: "cxr_flash_attention_f32", torch.bfloat16: "cxr_flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Exact softmax attention in fp32 on [BH, L, D] — the kernel's plain
    version. It holds the whole score matrix."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [BH, Lq, D], k/v [BH, Lk, D] -> [BH, Lq, D]: full attention, no mask.

    ``scale`` is the caller's (CvT passes ``embed_dim ** -0.5``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    req = _build.require
    req(q.is_cuda and k.device == q.device and v.device == q.device,
        "flash_attention: q, k, v must be on one CUDA device")
    req(q.dtype in _C and k.dtype == q.dtype and v.dtype == q.dtype,
        f"flash_attention: dtype must be float32 or bfloat16 for all of q, k, v, got "
        f"{q.dtype}, {k.dtype}, {v.dtype}")
    req(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
        and k.shape[0] == q.shape[0] and k.shape[2] == q.shape[2],
        f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    bh, lq, d = q.shape
    lk = k.shape[1]
    req(d == 64 and lk > 0, f"flash_attention: needs D = 64 and Lk > 0, got D={d}, Lk={lk}")
    req(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
        "flash_attention: q, k, v must be contiguous")
    out = torch.empty_like(q)
    if lq == 0 or bh == 0:
        return out
    name = _C[q.dtype]
    fn = _build.kernel(name, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, lq, lk, d, float(scale), _build.stream_of(q))
    _build.check(err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
