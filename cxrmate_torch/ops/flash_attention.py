"""CvT stage attention: flash (online-softmax) attention, for inference and
for training.

Replaces ``cxrmate_tpu/ops/flash_attention.py``:

  * :func:`flash_attention` ← ``flash_attention`` :60 (inference);
  * :func:`flash_attention_grad` ← ``flash_attention_grad`` :197, a
    ``torch.autograd.Function``: its forward is :func:`flash_attention_fwd_lse`
    (``_flash_fwd_kernel`` :109, which also writes the log-sum-exp rows), its
    backward computes ``delta = rowsum(dO * O)`` in plain PyTorch, as JAX
    does outside Pallas (:254), then :func:`flash_attention_bwd_dq`
    (``_flash_bwd_dq_kernel`` :137) and :func:`flash_attention_bwd_dkv`
    (``_flash_bwd_dkv_kernel`` :161).

The CUDA kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
never write the [Lq, Lk] score matrix; the source notes there say what bounds
them on the H100 and how the designs meet that. Each pass has two: bf16 runs
on Hopper's tensor cores (wgmma, tiles streamed by TMA; P, and in the
backward dS, is rounded to bf16 before it enters a product, which the TPU
kernels' fp32 p and ds are not), fp32 keeps a SIMT kernel (tensor cores would
compute in TF32).

On CPU tensors every wrapper runs its plain version (``*_plain``); on CUDA
tensors it launches its kernel or raises. :func:`flash_attention_grad_plain`
runs the plain versions in the same ``Function`` on any device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cxrmate_torch.ops import _build

_C = {torch.float32: "cxr_flash_attention_f32", torch.bfloat16: "cxr_flash_attention_bf16"}
_C_LSE = {torch.float32: "cxr_flash_attention_lse_f32",
          torch.bfloat16: "cxr_flash_attention_lse_bf16"}
_C_DQ = {torch.float32: "cxr_flash_bwd_dq_f32", torch.bfloat16: "cxr_flash_bwd_dq_bf16"}
_C_DKV = {torch.float32: "cxr_flash_bwd_dkv_f32", torch.bfloat16: "cxr_flash_bwd_dkv_bf16"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 4 + [_F, _P]
_ARGTYPES_LSE = [_P] * 5 + [_I] * 4 + [_F, _P]
_ARGTYPES_DQ = [_P] * 7 + [_I] * 4 + [_F, _P]
_ARGTYPES_DKV = [_P] * 8 + [_I] * 4 + [_F, _P]


# ------------------------------------------------------------ plain versions
def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Exact softmax attention in fp32 on [BH, L, D] — the kernel's plain
    version. It holds the whole score matrix."""
    p = torch.softmax(_scores(q, k, scale), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [BH, Lq, D] in q's dtype, lse [BH, Lq] fp32 = logsumexp of the
    scaled scores)."""
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.exp(s - lse[..., None]), v.float()).to(q.dtype)
    return out, lse


def _probs_and_ds(q, k, v, dout, lse, delta, scale):
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """dq = dS K with P = exp(S - lse), dS = P * (dO V^T - delta) * scale;
    fp32 inside, out in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = dS^T Q and dv = P^T dO (as the dq pass defines P and dS); fp32
    inside, out in k's and v's dtypes."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), dout.float()).to(v.dtype)
    return dk, dv


# ------------------------------------------------------------------ kernels
def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rows) -> None:
    """What every kernel of this module takes: q [BH, Lq, 64], k/v [BH, Lk,
    64] with Lk > 0, one CUDA device and dtype (float32 or bfloat16), all
    contiguous; ``rows`` are [BH, Lq, 64] tensors in q's dtype (dO). The bf16
    kernels read q, k, v (and dO) by TMA: 16-byte aligned, BH <= 65,535. The
    messages are built only on failure: CvT makes 21 of these calls per
    encode."""
    dev, dt, ts = q.device, q.dtype, (q, k, v, *rows)
    if (q.is_cuda and dt in _C and q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
            and k.shape[0] == q.shape[0] and q.shape[2] == 64 and k.shape[2] == 64
            and k.shape[1] > 0 and all(t.shape == q.shape for t in rows)
            and all(t.device == dev and t.dtype == dt and t.is_contiguous() for t in ts)
            and (dt != torch.bfloat16 or (q.shape[0] <= 65535
                                          and all(t.data_ptr() % 16 == 0 for t in ts)))):
        return
    req = _build.require
    req(q.is_cuda and all(t.device == dev for t in ts),
        f"{name}: every tensor must be on one CUDA device")
    req(dt in _C and all(t.dtype == dt for t in ts),
        f"{name}: dtype must be float32 or bfloat16 for all of q, k, v (and dout), got "
        f"{[t.dtype for t in ts]}")
    req(q.dim() == 3 and k.dim() == 3 and k.shape == v.shape
        and k.shape[0] == q.shape[0] and k.shape[2] == q.shape[2]
        and all(t.shape == q.shape for t in rows),
        f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
        f"rows {[tuple(t.shape) for t in rows]}")
    req(q.shape[2] == 64 and k.shape[1] > 0,
        f"{name}: needs D = 64 and Lk > 0, got D={q.shape[2]}, Lk={k.shape[1]}")
    req(all(t.is_contiguous() for t in ts), f"{name}: q, k, v (and dout) must be contiguous")
    req(False, f"{name}: the bf16 kernels read q, k, v (and dout) by TMA: 16-byte aligned, "
        "BH <= 65,535")


def _check_stats(name: str, q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    rows = q.shape[:2]
    for t in (lse, delta):
        if not (t.device == q.device and t.dtype == torch.float32 and t.is_contiguous()
                and t.shape == rows):
            _build.require(False, f"{name}: lse and delta must be contiguous float32 [BH, Lq] "
                                  "on q's device")


def _launch(table, argtypes, q: torch.Tensor, *args) -> None:
    name = table[q.dtype]
    fn = _build.kernel(name, argtypes)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args, _build.stream_of(q))
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, _build.stream_of(q))
    _build.check(err, name)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [BH, Lq, D], k/v [BH, Lk, D] -> [BH, Lq, D]: full attention, no mask.

    ``scale`` is the caller's (CvT passes ``embed_dim ** -0.5``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)
    bh, lq, d = q.shape
    out = torch.empty_like(q)
    if lq == 0 or bh == 0:
        return out
    _launch(_C, _ARGTYPES, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, lq, k.shape[1], d, float(scale))
    flash_attention.launches += 1
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: -> (out [BH, Lq, D], lse [BH, Lq] fp32). ``out``
    is bit-identical to :func:`flash_attention`'s (the same kernel)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, scale)
    _check("flash_attention_fwd_lse", q, k, v)
    bh, lq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(bh, lq, dtype=torch.float32, device=q.device)
    if lq == 0 or bh == 0:
        return out, lse
    _launch(_C_LSE, _ARGTYPES_LSE, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, lq, k.shape[1], d, float(scale))
    flash_attention_fwd_lse.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """dq [BH, Lq, D] in q's dtype (see :func:`flash_attention_bwd_dq_plain`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    _check("flash_attention_bwd_dq", q, k, v, dout)
    _check_stats("flash_attention_bwd_dq", q, lse, delta)
    bh, lq, d = q.shape
    dq = torch.empty_like(q)
    if lq == 0 or bh == 0:
        return dq
    _launch(_C_DQ, _ARGTYPES_DQ, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, lq, k.shape[1], d,
            float(scale))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [BH, Lk, D] in k's dtype (see
    :func:`flash_attention_bwd_dkv_plain`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale)
    _check("flash_attention_bwd_dkv", q, k, v, dout)
    _check_stats("flash_attention_bwd_dkv", q, lse, delta)
    bh, lq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0:
        return dk, dv
    if lq == 0:  # no query: nothing flows back
        return dk.zero_(), dv.zero_()
    _launch(_C_DKV, _ARGTYPES_DKV, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, lq, k.shape[1],
            d, float(scale))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


for _fn in (flash_attention, flash_attention_fwd_lse, flash_attention_bwd_dq,
            flash_attention_bwd_dkv):
    _fn.launches = 0


# ------------------------------------------------------------ differentiable
class _FlashAttentionGrad(torch.autograd.Function):
    """FlashAttention-2: the forward saves (q, k, v, out, lse); the backward
    recomputes the probabilities block by block. ``plain`` selects the plain
    versions of the three passes instead of the wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plain: bool):
        fwd = flash_attention_fwd_lse_plain if plain else flash_attention_fwd_lse
        out, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1)  # [BH, Lq], outside the kernels
        if ctx.plain:
            dq_fn, dkv_fn = flash_attention_bwd_dq_plain, flash_attention_bwd_dkv_plain
        else:
            dq_fn, dkv_fn = flash_attention_bwd_dq, flash_attention_bwd_dkv
        dq = dq_fn(q, k, v, dout, lse, delta, ctx.scale)
        dk, dv = dkv_fn(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Differentiable :func:`flash_attention` (same forward output): on CUDA
    tensors the forward launches the LSE kernel and the backward the dq and
    dk/dv kernels, and nothing else."""
    return _FlashAttentionGrad.apply(q, k, v, scale, False)


def flash_attention_grad_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """:func:`flash_attention_grad` over the plain versions of its three
    passes, in the same ``Function``."""
    return _FlashAttentionGrad.apply(q, k, v, scale, True)
