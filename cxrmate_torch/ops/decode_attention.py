"""Decode attention for one step against a cached K/V, kernel 2 of the port.

Replaces ``cxrmate_tpu/ops/decode_attention.py:50 decode_attention`` (and its
TPU blockings :98 and :149, the same function). The CUDA kernel
(``csrc/decode_attention.cu``) keeps the contract's op order: fp32 scores,
x scale, + the f32 additive mask, max-subtracted fp32 softmax, probs rounded to
the input dtype before P.V, fp32 context. Its source note says what bounds it
on the H100 and how the design meets that.

On a CPU tensor :func:`decode_attention` runs :func:`decode_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cxrmate_torch.ops import _build

_C = {torch.float32: "cxr_decode_attention_f32", torch.bfloat16: "cxr_decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_THREADS = 256
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_MAX_M = 4


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's plain version: the eager-order attention of
    ``ops.layers.attention`` with a [B, S] mask."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + additive_mask.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def smem_bytes(m: int, s: int, dh: int) -> int:
    """Shared memory of one block: q, the [M, S] scores and the per-warp
    partial contexts, all fp32."""
    return 4 * (m * dh + m * s + (_THREADS // 32) * m * dh)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, H, M, dh] vs cached k/v [B, H, S, dh] with a [B, S] fp32 additive
    key mask -> ctx [B, H, M, dh]. M is 1 (greedy) or the beam count."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, additive_mask, scale)
    req = _build.require
    req(q.is_cuda and all(t.device == q.device for t in (k, v, additive_mask)),
        "decode_attention: q, k, v and the mask must be on one CUDA device")
    req(q.dtype in _C and k.dtype == q.dtype and v.dtype == q.dtype,
        f"decode_attention: q, k, v must share a dtype of float32 or bfloat16, got "
        f"{q.dtype}, {k.dtype}, {v.dtype}")
    req(additive_mask.dtype == torch.float32, "decode_attention: the mask must be float32")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
        and k.shape[:2] == q.shape[:2] and k.shape[3] == q.shape[3],
        f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, m, dh = q.shape
    s = k.shape[2]
    req(tuple(additive_mask.shape) == (b, s),
        f"decode_attention: mask shape {tuple(additive_mask.shape)} != {(b, s)}")
    req(dh == 64, f"decode_attention: needs head dim 64, got {dh}")
    req(1 <= m <= _MAX_M and s >= 1, f"decode_attention: needs 1 <= M <= {_MAX_M}, S >= 1")
    req(smem_bytes(m, s, dh) <= _SMEM_LIMIT,
        f"decode_attention: M={m} x S={s} scores exceed one block's shared memory")
    req(all(t.is_contiguous() for t in (q, k, v, additive_mask)),
        "decode_attention: q, k, v and the mask must be contiguous")
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    name = _C[q.dtype]
    fn = _build.kernel(name, _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), additive_mask.data_ptr(),
                 out.data_ptr(), b * h, h, m, s, dh, float(scale), _build.stream_of(q))
    _build.check(err, name)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
