"""Fused decoder-layer decode step: one BERT decoder layer for one new token
per study in four kernels (v2) or one (v1), instead of some twenty PyTorch
calls.

The port of ``cxrmate_tpu/ops/fused_decode.py:366 fused_layer_step_v2`` and its
four Pallas bodies. Each has a CUDA kernel here (``csrc/fused_*.cu``, shared
device code in ``csrc/fused_decode.cuh``; the cross-attention kernel is the
split decode body of ``csrc/decode_split.cuh`` under its own contract), a
wrapper and a plain version:

  ====================== ============================== =======================
  wrapper                replaces (fused_decode.py)     source
  ====================== ============================== =======================
  ``fused_qkv_attn``     :251 ``_qkv_attn_kernel_v2``   ``fused_qkv_attn.cu``
  ``fused_out_ln_q``     :304 ``_out_ln_q_kernel``      ``fused_out_ln_q.cu``
  ``fused_cross_attn``   :291 ``_cross_attn_kernel_v2`` ``fused_cross_attn.cu``
  ``fused_out_ln_ffn``   :320 ``_out_ln_ffn_kernel``    ``fused_out_ln_ffn.cu``
  ====================== ============================== =======================

Every matrix product, LayerNorm, GELU and attention of the layer is computed
inside these kernels. Everything inside a kernel is fp32, weights included;
between kernels the values are rounded to the hidden dtype (ctx, h1, cq, cctx,
out) and the new K/V to the cache dtype. The rounding points are those of the
Pallas bodies, not those of the unfused ``models.bert.bert_step``: q is never
rounded; the new token's own score and its share of the context use the
unrounded k_new/v_new while later steps read the rounded cache; the softmax
probabilities are not rounded before P.V; cq comes from the unrounded
LayerNorm output; the FFN's residual is the unrounded LayerNorm output, the
cross sublayer's the rounded h1. GELU is the exact erf one (``erff`` in the
kernel, ``torch.erf`` in the plain version; the Pallas body's rational erf is
within 1.5e-7 of it).

Layouts, the port's own. Activations between the kernels are [B, D] with the
heads side by side: no transposes. Weights stay as ``nn.Linear`` holds them,
[out, in]: one output's weights are contiguous, so a warp that owns an output
reads them with neighbouring lanes on neighbouring 16 bytes.
:func:`prepare_fused_params` only concatenates the q, k and v weights of a
layer into one [3D, D] matrix (one dense pass instead of three) and gathers
the other parameters into tuples, once per ``generate`` call.

The self cache is updated in place: ``fused_qkv_attn`` writes the new token's
K/V into column ``index`` (the JAX function returns new arrays).

:func:`fused_layer_step` is the port of v1 (``fused_decode.py:164``, one
``pallas_call`` for the whole layer): the same stages in one cooperative
launch (``csrc/fused_layer_step.cu``) with v1's rounding points: everything
from the input to the outputs stays fp32 (ctx, h1, cq, cctx are not rounded,
as v2 rounds them), and only ``out`` and the new K/V column are rounded. No
path of the JAX package calls v1, and none of the port does: it is a function,
held to the JAX kernel on the CPU and to its plain version on the card.

On CPU tensors a wrapper runs its ``*_plain`` version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from cxrmate_torch.ops import _build
from cxrmate_torch.ops import decode_attention as da
from cxrmate_torch.ops.layers import LoraLinear

NEG = float(torch.finfo(torch.float32).min)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_DH = 64              # the head dim the kernels are written for
_ROWS = 8             # batch rows a dense pass carries per weight read
_DENSE_WARPS = 16
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _attend_floats(n: int, warps: int) -> int:
    return (n + 1 + 3) // 4 * 4 + warps * _DH


# Dynamic shared memory (bytes) of one block of each dense kernel, as the
# launchers compute it: the fp32 input rows of a dense pass (8 x D, for the
# FFN 8 x (D + F)), or the scores of T + 1 keys and the per-warp contexts.
def _smem_qkv_attn(d_model: int, t_len: int) -> int:
    # stage 1: the rows, then the slices' partials of the block's outputs
    return 4 * max(2 * _ROWS * d_model, 3 * _DH + _attend_floats(t_len, _DENSE_WARPS))


def _smem_out_ln_q(d_model: int) -> int:
    return 4 * _ROWS * d_model


def cross_fits(s_len: int, itemsize: int) -> bool:
    """Whether :func:`fused_cross_attn` takes S = ``s_len`` keys of
    ``itemsize`` bytes: its block (the split decode body at M = 1,
    ``csrc/decode_split.cuh``) fits in shared memory, up to
    ``decode_attention.max_keys(1, 64, itemsize)`` keys."""
    return s_len >= 1 and da.smem_bytes(1, s_len, _DH, itemsize) <= da._SPLIT_SMEM_LIMIT


def _smem_out_ln_ffn(d_model: int, d_ff: int) -> int:
    return 4 * _ROWS * (d_model + max(d_model, d_ff))


_SLICE_VECS = 32  # 16-byte weight vectors of a K-slice of a split-K pass
_PASS_WARPS = 16  # warps of a block of the kernels with split-K passes


def pass_slices(n_in: int, itemsize: int) -> int:
    """K-slices of a split-K pass (:func:`fused_qkv_attn`'s projection,
    :func:`fused_out_ln_ffn`'s three products) over ``n_in`` inputs of
    ``itemsize`` bytes: each weight row cut into slices of _SLICE_VECS 16-byte
    vectors (one a lane), a function of the width and dtype alone
    (``csrc/fused_decode.cuh:slices``)."""
    return -(-(n_in * itemsize // 16) // _SLICE_VECS)


def _warp_runs(ub: int, ue: int):
    """(warp, unit) of the units [ub, ue) of a block: contiguous runs as even
    as can be, one a warp (``split_pass``)."""
    n = ue - ub
    for w in range(_PASS_WARPS):
        for u in range(ub + n * w // _PASS_WARPS, ub + n * (w + 1) // _PASS_WARPS):
            yield w, u


def _block_units(n_out: int, n_in: int, part: int, itemsize: int, grid: int) -> list:
    """(block, warp, output, slice) of a pass whose block b owns the outputs
    [n_out b / grid, n_out (b + 1) / grid), taken in rounds of as many outputs
    as ``part`` floats of shared-memory partials hold (_ROWS a unit), each
    round's units slice by slice (``block_outputs``)."""
    ks = pass_slices(n_in, itemsize)
    cap = part // ks
    out = []
    for b in range(grid):
        lo, hi = n_out * b // grid, n_out * (b + 1) // grid
        for o0 in range(lo, hi, cap):
            n_o = min(cap, hi - o0)
            out += [(b, w, o0 + u % n_o, u // n_o) for w, u in _warp_runs(0, ks * n_o)]
    return out


def ffn_units(d_model: int, d_ff: int, itemsize: int, grid: int) -> dict:
    """The ownership map of :func:`fused_out_ln_ffn`'s three split-K passes
    on a grid of ``grid`` blocks, as the kernel computes it: {"wo" | "w1" |
    "w2": [(block, warp, output, slice), ...]}. Wo and W1: block b owns the
    outputs [n b / grid, n (b + 1) / grid), in rounds as its shared-memory
    partials hold them (hs for Wo, xs for W1); W2: the units (slice k, output
    o), slice by slice, cut into ``grid`` equal runs, one a block."""
    units = {"wo": _block_units(d_model, d_model, d_model, itemsize, grid),
             "w1": _block_units(d_ff, d_model, max(d_model, d_ff), itemsize, grid)}
    n2 = pass_slices(d_ff, itemsize) * d_model
    units["w2"] = [(b, w, u % d_model, u // d_model) for b in range(grid)
                   for w, u in _warp_runs(n2 * b // grid, n2 * (b + 1) // grid)]
    return units


def qkv_units(d_model: int, itemsize: int, grid: int) -> list:
    """The ownership map of :func:`fused_qkv_attn`'s split-K projection on a
    grid of ``grid`` blocks, as the kernel computes it: [(block, warp,
    output, slice), ...] over the [3D, D] weight, block b owning the outputs
    [3D b / grid, 3D (b + 1) / grid), their partials in D floats a row."""
    return _block_units(3 * d_model, d_model, d_model, itemsize, grid)


_STEP_WARPS = 16  # warps per block of the v1 kernel, attention stages included


def _smem_layer_step(d_model: int, d_ff: int, t_len: int, s_len: int) -> int:
    """Dynamic shared memory (bytes) of the v1 kernel's blocks: the largest of
    its stages' (v2's four, with 16 warps in the cross stage)."""
    return 4 * max(_ROWS * d_model, 3 * _DH + _attend_floats(t_len, _STEP_WARPS),
                   _DH + _attend_floats(s_len, _STEP_WARPS),
                   _ROWS * (d_model + max(d_model, d_ff)))


def supports(layer, cache_k: torch.Tensor, cross_k: torch.Tensor, version: int = 2) -> bool:
    """Whether the fused step (``version`` 2: :func:`fused_layer_step_v2`; 1:
    :func:`fused_layer_step`) applies to this layer and these caches: no LoRA
    (as ``fused_decode.py:219``), and the kernels' own limits in place of the
    TPU's memory budget: float32 or bfloat16, head dim 64, widths that are
    multiples of 8, and the shared memory one block may use (the T + 1 and S
    scores, the 8 x (D + F) fp32 rows of the FFN; v2's S up to
    :func:`cross_fits`, a cluster's share of it a block). ``models.bert.bert_step``
    does not ask (its gate is no LoRA and no deferred write, as in the JAX
    package); on the card a wrapper raises on what its kernel does not take."""
    if isinstance(layer.attention.self.query, LoraLinear):
        return False
    if cache_k.dtype not in _SUFFIX or cross_k.dtype != cache_k.dtype:
        return False
    if cache_k.dim() != 4 or cross_k.dim() != 4 or cache_k.shape[3] != _DH:
        return False
    d_ff, d_model = layer.intermediate.dense.weight.shape
    if d_model != cache_k.shape[1] * _DH or d_model % 8 or d_ff % 8:
        return False
    if version == 1:
        return _smem_layer_step(d_model, d_ff, cache_k.shape[2], cross_k.shape[2]) <= _SMEM_LIMIT
    need = max(_smem_qkv_attn(d_model, cache_k.shape[2]), _smem_out_ln_q(d_model),
               _smem_out_ln_ffn(d_model, d_ff))
    return need <= _SMEM_LIMIT and cross_fits(cross_k.shape[2], cross_k.element_size())


# ------------------------------------------------------------ plain versions
def _layer_norm_f32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _dense_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.float().t()) + b.float()


def _self_attn_f32(hidden, wqkv, bqkv, cache_k, cache_v, index: int, key_mask):
    """The self-attention stage, fp32 ctx [B, D]; writes the cache column."""
    b, d = hidden.shape
    h, t, dh = cache_k.shape[1:]
    scale = 1.0 / math.sqrt(dh)
    q, kn, vn = (x.reshape(b, h, dh) for x in _dense_f32(hidden.float(), wqkv, bqkv).split(d, 1))
    km = key_mask.float()
    cols = torch.arange(t, device=hidden.device)
    add_old = (1.0 - km * (cols < index).float()) * NEG  # [B, T]
    add_new = (1.0 - km[:, index]) * NEG                 # [B]
    s_old = torch.einsum("bhd,bhtd->bht", q, cache_k.float()) * scale + add_old[:, None, :]
    s_new = (q * kn).sum(-1, keepdim=True) * scale + add_new[:, None, None]
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    ctx = torch.einsum("bht,bhtd->bhd", p[..., :t], cache_v.float()) + p[..., t:] * vn
    cache_k[:, :, index] = kn.to(cache_k.dtype)
    cache_v[:, :, index] = vn.to(cache_v.dtype)
    return ctx.reshape(b, d)


def fused_qkv_attn_plain(hidden, wqkv, bqkv, cache_k, cache_v, index: int, key_mask):
    """The plain version of :func:`fused_qkv_attn`, the op order of
    ``_qkv_attn_kernel_v2`` (:257-288): the T cached columns masked by
    ``key_mask * (col < index)``, the new token as column T + 1 masked by
    ``key_mask[:, index]``, scored and weighted with its unrounded fp32 K/V.
    Reads the cache as it is, then writes column ``index``."""
    return _self_attn_f32(hidden, wqkv, bqkv, cache_k, cache_v, index,
                          key_mask).to(hidden.dtype)


def _out_ln_q_f32(ctx, res, wo, bo, gamma, beta, wq, bq, eps: float):
    y = _layer_norm_f32(_dense_f32(ctx.float(), wo, bo) + res.float(), gamma, beta, eps)
    return y, _dense_f32(y, wq, bq)


def fused_out_ln_q_plain(ctx, res, wo, bo, gamma, beta, wq, bq, eps: float):
    """The plain version of :func:`fused_out_ln_q` (``_out_ln_q_kernel``
    :307-317): cq is computed from the unrounded LayerNorm output."""
    y, cq = _out_ln_q_f32(ctx, res, wo, bo, gamma, beta, wq, bq, eps)
    return y.to(ctx.dtype), cq.to(ctx.dtype)


def _cross_attn_f32(cq, cross_k, cross_v, cross_mask):
    b, d = cq.shape
    h, _, dh = cross_k.shape[1:]
    add = (1.0 - cross_mask.float()) * NEG
    s = torch.einsum("bhd,bhsd->bhs", cq.float().reshape(b, h, dh), cross_k.float())
    p = torch.softmax(s * (1.0 / math.sqrt(dh)) + add[:, None, :], dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, cross_v.float()).reshape(b, d)


def fused_cross_attn_plain(cq, cross_k, cross_v, cross_mask):
    """The plain version of :func:`fused_cross_attn` (``_cross_attn_kernel_v2``
    :292-301): fp32 probabilities, not rounded before P.V."""
    return _cross_attn_f32(cq, cross_k, cross_v, cross_mask).to(cq.dtype)


def _out_ln_ffn_f32(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3, beta3,
                    eps: float):
    h = _layer_norm_f32(_dense_f32(cctx.float(), wo, bo) + res.float(), gamma2, beta2, eps)
    z = _dense_f32(h, w1, b1)
    z = z * (0.5 * (1.0 + torch.erf(z * (2.0 ** -0.5))))
    return _layer_norm_f32(_dense_f32(z, w2, b2) + h, gamma3, beta3, eps)


def fused_out_ln_ffn_plain(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3, beta3,
                           eps: float):
    """The plain version of :func:`fused_out_ln_ffn` (``_out_ln_ffn_kernel``
    :324-339), with ``torch.erf`` for the GELU; the FFN's residual is the
    unrounded LayerNorm output."""
    return _out_ln_ffn_f32(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3, beta3,
                           eps).to(cctx.dtype)


# ------------------------------------------------------------------ wrappers
def _pointers(name: str, dtype, device, specs) -> list:
    """Reject what the kernels do not take, and return the data pointers:
    every tensor on one CUDA device, of one dtype (float32 or bfloat16; int32
    where a spec says so), contiguous, 16-byte aligned and of the given shape.
    ``specs``: (tensor, shape, dtype or None for the common one). The message
    is only built on failure: a decode step makes 24 of these calls."""
    ok = device.type == "cuda" and dtype in _SUFFIX
    ptrs = []
    if ok:
        for x, shape, dt in specs:
            ptr = x.data_ptr()
            if not (x.dtype == (dt or dtype) and x.device == device and x.shape == shape
                    and x.is_contiguous() and ptr % 16 == 0):
                ok = False
                break
            ptrs.append(ptr)
    if not ok:
        got = ", ".join(f"{i}: {x.dtype} {tuple(x.shape)} on {x.device}"
                        f"{'' if x.is_contiguous() else ' (not contiguous)'}"
                        for i, (x, _, _) in enumerate(specs))
        want = ", ".join(f"{i}: {dt or 'float32 or bfloat16'} {tuple(shape)}"
                         for i, (_, shape, dt) in enumerate(specs))
        raise ValueError(f"{name}: needs contiguous, 16-byte aligned tensors on one CUDA device, "
                         f"{want}; got {got}")
    return ptrs


def _check_smem(name: str, need: int) -> None:
    if need > _SMEM_LIMIT:
        raise ValueError(f"{name}: needs {need} bytes of shared memory per block, the card has "
                         f"{_SMEM_LIMIT}")


def _launch(entry: str, argtypes, device, *args) -> None:
    """Launch the C entry on PyTorch's current stream of ``device``; raise if
    the launch was refused."""
    fn = _build.kernel(entry, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    _build.check(err, entry)


_ARGS_QKV = [_P] * 8 + [_I] * 6 + [_F, _P]


def fused_qkv_attn(hidden: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                   cache_k: torch.Tensor, cache_v: torch.Tensor, index: int,
                   key_mask: torch.Tensor) -> torch.Tensor:
    """hidden [B, D]; wqkv [3D, D] and bqkv [3D] (q, k, v of ``nn.Linear``
    stacked); cache_k/cache_v [B, H, T, 64]; key_mask [B, T] int32 (non-zero =
    may be attended; only columns below ``index``, and ``index`` itself for the
    new token, count) -> ctx [B, D]. Writes the new token's K/V into column
    ``index`` of the caches, in place."""
    if hidden.device.type == "cpu":
        return fused_qkv_attn_plain(hidden, wqkv, bqkv, cache_k, cache_v, index, key_mask)
    name = "fused_qkv_attn"
    if hidden.dim() != 2 or cache_k.dim() != 4:
        raise ValueError(f"{name}: hidden must be [B, D] and the caches 4-D")
    b, d = hidden.shape
    _, h, t, dh = cache_k.shape
    if dh != _DH or d != h * dh:
        raise ValueError(f"{name}: needs head dim {_DH} and D = H x {_DH}, got D={d}, H={h}, "
                         f"dh={dh}")
    if not 0 <= index < t:
        raise ValueError(f"{name}: index {index} outside [0, {t})")
    dev = hidden.device
    ptrs = _pointers(name, hidden.dtype, dev, (
        (hidden, (b, d), None), (wqkv, (3 * d, d), None), (bqkv, (3 * d,), None),
        (cache_k, (b, h, t, dh), None), (cache_v, (b, h, t, dh), None),
        (key_mask, (b, t), torch.int32)))
    _check_smem(name, _smem_qkv_attn(d, t))
    ctx = torch.empty_like(hidden)
    if b == 0:
        return ctx
    scratch = torch.empty(b, 3 * d, dtype=torch.float32, device=dev)
    _launch(f"cxr_fused_qkv_attn_{_SUFFIX[hidden.dtype]}", _ARGS_QKV, dev, *ptrs, ctx.data_ptr(),
            scratch.data_ptr(), b, h, t, d, dh, int(index), 1.0 / math.sqrt(dh))
    fused_qkv_attn.launches += 1
    return ctx


fused_qkv_attn.launches = 0

_ARGS_LNQ = [_P] * 11 + [_I] * 2 + [_F, _P]


def fused_out_ln_q(ctx: torch.Tensor, res: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                   gamma: torch.Tensor, beta: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """ctx, res [B, D]; wo, wq [D, D] ([out, in]); bo, gamma, beta, bq [D] ->
    (h1, cq), both [B, D]: h1 = LayerNorm(ctx wo^T + bo + res), cq = h1 wq^T +
    bq from the unrounded h1."""
    if ctx.device.type == "cpu":
        return fused_out_ln_q_plain(ctx, res, wo, bo, gamma, beta, wq, bq, eps)
    name = "fused_out_ln_q"
    if ctx.dim() != 2 or ctx.shape[1] % 8 or not ctx.shape[1]:
        raise ValueError(f"{name}: ctx must be [B, D] with D a multiple of 8")
    b, d = ctx.shape
    dev = ctx.device
    ptrs = _pointers(name, ctx.dtype, dev, (
        (ctx, (b, d), None), (res, (b, d), None), (wo, (d, d), None), (bo, (d,), None),
        (gamma, (d,), None), (beta, (d,), None), (wq, (d, d), None), (bq, (d,), None)))
    _check_smem(name, _smem_out_ln_q(d))
    h1, cq = torch.empty_like(ctx), torch.empty_like(ctx)
    if b == 0:
        return h1, cq
    scratch = torch.empty(b, d, dtype=torch.float32, device=dev)
    _launch(f"cxr_fused_out_ln_q_{_SUFFIX[ctx.dtype]}", _ARGS_LNQ, dev, *ptrs, h1.data_ptr(),
            cq.data_ptr(), scratch.data_ptr(), b, d, float(eps))
    fused_out_ln_q.launches += 1
    return h1, cq


fused_out_ln_q.launches = 0

_ARGS_CROSS = [_P] * 5 + [_I] * 6 + [_F, _P]


def fused_cross_attn(cq: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                     cross_mask: torch.Tensor) -> torch.Tensor:
    """cq [B, D] (heads side by side); cross_k/cross_v [B, H, S, 64];
    cross_mask [B, S] int32 (non-zero = may be attended) -> cctx [B, D].
    On the card one launch of a thread-block cluster per (study, head), the
    split of ``decode_attention.decode_schedule(S, 64)``; S up to
    :func:`cross_fits`."""
    if cq.device.type == "cpu":
        return fused_cross_attn_plain(cq, cross_k, cross_v, cross_mask)
    name = "fused_cross_attn"
    if cq.dim() != 2 or cross_k.dim() != 4:
        raise ValueError(f"{name}: cq must be [B, D] and the cross K/V 4-D")
    b, d = cq.shape
    _, h, s, dh = cross_k.shape
    if dh != _DH or d != h * dh or s < 1:
        raise ValueError(f"{name}: needs head dim {_DH}, D = H x {_DH} and S >= 1, got D={d}, "
                         f"H={h}, dh={dh}, S={s}")
    dev = cq.device
    ptrs = _pointers(name, cq.dtype, dev, (
        (cq, (b, d), None), (cross_k, (b, h, s, dh), None), (cross_v, (b, h, s, dh), None),
        (cross_mask, (b, s), torch.int32)))
    if not cross_fits(s, cross_k.element_size()):
        raise ValueError(f"{name}: S={s} exceeds the "
                         f"{da.max_keys(1, dh, cross_k.element_size())} keys a cluster of "
                         f"{da.MAX_SPLIT} blocks holds with {cross_k.dtype} K/V")
    cctx = torch.empty_like(cq)
    if b == 0:
        return cctx
    n_split, chunk = da.decode_schedule(s, dh)
    _launch(f"cxr_fused_cross_attn_{_SUFFIX[cq.dtype]}", _ARGS_CROSS, dev, *ptrs,
            cctx.data_ptr(), b * h, h, s, dh, n_split, chunk, 1.0 / math.sqrt(dh))
    fused_cross_attn.launches += 1
    return cctx


fused_cross_attn.launches = 0

_ARGS_FFN = [_P] * 14 + [_I] * 3 + [_F, _P]


def fused_out_ln_ffn(cctx: torch.Tensor, res: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                     gamma2: torch.Tensor, beta2: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, gamma3: torch.Tensor,
                     beta3: torch.Tensor, eps: float) -> torch.Tensor:
    """cctx, res [B, D]; wo [D, D], w1 [F, D], w2 [D, F] ([out, in]); b1 [F];
    the other vectors [D] -> out [B, D]: h = LayerNorm(cctx wo^T + bo + res),
    out = LayerNorm(gelu(h w1^T + b1) w2^T + b2 + h)."""
    if cctx.device.type == "cpu":
        return fused_out_ln_ffn_plain(cctx, res, wo, bo, gamma2, beta2, w1, b1, w2, b2, gamma3,
                                      beta3, eps)
    name = "fused_out_ln_ffn"
    if cctx.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"{name}: cctx must be [B, D] and w1 [F, D]")
    b, d = cctx.shape
    f = w1.shape[0]
    if not d or not f or d % 8 or f % 8:
        raise ValueError(f"{name}: D and F must be multiples of 8, got {d}, {f}")
    dev = cctx.device
    ptrs = _pointers(name, cctx.dtype, dev, (
        (cctx, (b, d), None), (res, (b, d), None), (wo, (d, d), None), (bo, (d,), None),
        (gamma2, (d,), None), (beta2, (d,), None), (w1, (f, d), None), (b1, (f,), None),
        (w2, (d, f), None), (b2, (d,), None), (gamma3, (d,), None), (beta3, (d,), None)))
    _check_smem(name, _smem_out_ln_ffn(d, f))
    out = torch.empty_like(cctx)
    if b == 0:
        return out
    # y1 [B, D], z [B, F], W2's partials [slices][8][D]
    scratch = torch.empty(b * (d + f) + pass_slices(f, cctx.element_size()) * _ROWS * d,
                          dtype=torch.float32, device=dev)
    _launch(f"cxr_fused_out_ln_ffn_{_SUFFIX[cctx.dtype]}", _ARGS_FFN, dev, *ptrs, out.data_ptr(),
            scratch.data_ptr(), b, d, f, float(eps))
    fused_out_ln_ffn.launches += 1
    return out


fused_out_ln_ffn.launches = 0


# ------------------------------------------------------------- the layer step
def _prepare_layer(layer) -> dict:
    sa, ca = layer.attention, layer.crossattention
    if isinstance(sa.self.query, LoraLinear):
        raise ValueError("the fused decode step has no LoRA: use the unfused path")

    def c(p):
        return p.detach().contiguous()

    qkv = (sa.self.query, sa.self.key, sa.self.value)
    return {
        "wqkv": torch.cat([c(m.weight) for m in qkv]),  # [3D, D]
        "bqkv": torch.cat([c(m.bias) for m in qkv]),    # [3D]
        "out_ln_q": tuple(c(p) for p in (
            sa.output.dense.weight, sa.output.dense.bias, sa.output.LayerNorm.weight,
            sa.output.LayerNorm.bias, ca.self.query.weight, ca.self.query.bias)),
        "out_ln_ffn": tuple(c(p) for p in (
            ca.output.dense.weight, ca.output.dense.bias, ca.output.LayerNorm.weight,
            ca.output.LayerNorm.bias, layer.intermediate.dense.weight,
            layer.intermediate.dense.bias, layer.output.dense.weight, layer.output.dense.bias,
            layer.output.LayerNorm.weight, layer.output.LayerNorm.bias)),
    }


def prepare_fused_params(model, heads: int) -> List[dict]:
    """Per-layer operands of the four kernels, built once per ``generate``
    call and never per step (``fused_decode.py:342``). ``model`` is the
    decoder (``BertLMHeadModel``). Per layer: ``wqkv`` [3D, D] and ``bqkv``
    [3D], the q, k and v ``nn.Linear`` weights stacked in their own [out, in]
    layout (the one copy made), and ``out_ln_q`` / ``out_ln_ffn``, the other
    parameters as the tuples the wrappers take, so that a step looks up no
    module attribute. ``heads`` is checked against the width."""
    layers = model.bert.encoder.layer
    d = layers[0].attention.output.dense.weight.shape[0] if len(layers) else 0
    if heads < 1 or d % heads:
        raise ValueError(f"hidden size {d} is not a multiple of {heads} heads")
    return [_prepare_layer(layer) for layer in layers]


def fused_layer_step_v2(hidden: torch.Tensor, layer, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                        index: int, key_mask: torch.Tensor, cross_mask: torch.Tensor,
                        eps: float = 1e-12, prepared: Optional[dict] = None) -> torch.Tensor:
    """One decoder layer for the token at cache column ``index``.

    hidden [B, D]; ``layer`` the decoder's layer module (no LoRA); cache_k,
    cache_v [B, H, T, dh] and cross_k, cross_v [B, H, S, dh]; ``index`` a
    Python int; key_mask [B, T] (includes the current position; columns below
    ``index`` and the new token's own are used) and cross_mask [B, S], non-zero
    = may be attended; ``prepared`` this layer's entry of
    :func:`prepare_fused_params` (built here if missing: pass it in a loop).

    Returns hidden_out [B, D]. The new token's K/V are written into column
    ``index`` of ``cache_k``/``cache_v`` in place (the JAX function returns
    updated copies). On CPU tensors the four plain versions run, on CUDA
    tensors the four kernels."""
    if prepared is None:
        prepared = _prepare_layer(layer)
    key_mask = key_mask.to(torch.int32)      # no copies when they are int32 already
    cross_mask = cross_mask.to(torch.int32)
    ctx = fused_qkv_attn(hidden, prepared["wqkv"], prepared["bqkv"], cache_k, cache_v, index,
                         key_mask)
    h1, cq = fused_out_ln_q(ctx, hidden, *prepared["out_ln_q"], eps)
    cctx = fused_cross_attn(cq, cross_k, cross_v, cross_mask)
    return fused_out_ln_ffn(cctx, h1, *prepared["out_ln_ffn"], eps)


# ----------------------------------------------------------------- v1: one kernel
def fused_layer_step_plain(hidden: torch.Tensor, layer, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, cross_k: torch.Tensor, cross_v: torch.Tensor,
                           index: int, key_mask: torch.Tensor, cross_mask: torch.Tensor,
                           eps: float = 1e-12, prepared: Optional[dict] = None):
    """The plain version of :func:`fused_layer_step`: v2's stages in fp32
    torch ops with nothing rounded in between (``_kernel`` :71-161); only
    hidden_out and the new K/V column are rounded."""
    if prepared is None:
        prepared = _prepare_layer(layer)
    ctx = _self_attn_f32(hidden, prepared["wqkv"], prepared["bqkv"], cache_k, cache_v, index,
                         key_mask)
    h1, cq = _out_ln_q_f32(ctx, hidden, *prepared["out_ln_q"], eps)
    cctx = _cross_attn_f32(cq, cross_k, cross_v, cross_mask)
    out = _out_ln_ffn_f32(cctx, h1, *prepared["out_ln_ffn"], eps)
    return out.to(hidden.dtype), cache_k, cache_v


_ARGS_STEP = [ctypes.POINTER(_P)] + [_I] * 8 + [_F] * 2 + [_P]


def fused_layer_step(hidden: torch.Tensor, layer, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cross_k: torch.Tensor, cross_v: torch.Tensor, index: int,
                     key_mask: torch.Tensor, cross_mask: torch.Tensor, eps: float = 1e-12,
                     prepared: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v1 (``fused_decode.py:164``): one decoder layer for the token at cache
    column ``index`` in one kernel, fp32 from the input to the outputs.

    Arguments as :func:`fused_layer_step_v2` (the JAX order; ``layer`` the
    decoder's layer module, or None with ``prepared``). Returns (hidden_out
    [B, D], cache_k, cache_v) as the JAX function does, but the caches are the
    ones passed in: the new token's K/V, rounded to the cache dtype, are
    written into their column ``index`` in place. On CPU tensors the plain
    version runs; on CUDA tensors the kernel (``csrc/fused_layer_step.cu``)
    or an error."""
    if prepared is None:
        prepared = _prepare_layer(layer)
    key_mask = key_mask.to(torch.int32)
    cross_mask = cross_mask.to(torch.int32)
    if hidden.device.type == "cpu":
        return fused_layer_step_plain(hidden, layer, cache_k, cache_v, cross_k, cross_v, index,
                                      key_mask, cross_mask, eps, prepared)
    name = "fused_layer_step"
    if hidden.dim() != 2 or cache_k.dim() != 4 or cross_k.dim() != 4:
        raise ValueError(f"{name}: hidden must be [B, D] and the caches 4-D")
    b, d = hidden.shape
    _, h, t, dh = cache_k.shape
    s, f = cross_k.shape[2], prepared["out_ln_ffn"][4].shape[0]
    if dh != _DH or d != h * dh or d % 8 or f % 8 or not f or s < 1:
        raise ValueError(f"{name}: needs head dim {_DH}, D = H x {_DH}, F a multiple of 8 and "
                         f"S >= 1, got D={d}, H={h}, dh={dh}, F={f}, S={s}")
    if not 0 <= index < t:
        raise ValueError(f"{name}: index {index} outside [0, {t})")
    dev = hidden.device
    vec, mat = (d,), (d, d)
    ptrs = _pointers(name, hidden.dtype, dev, (
        (hidden, (b, d), None), (prepared["wqkv"], (3 * d, d), None),
        (prepared["bqkv"], (3 * d,), None),
        *zip(prepared["out_ln_q"], (mat, vec, vec, vec, mat, vec), (None,) * 6),
        *zip(prepared["out_ln_ffn"], (mat, vec, vec, vec, (f, d), (f,), (d, f), vec, vec, vec),
             (None,) * 10),
        (cache_k, (b, h, t, dh), None), (cache_v, (b, h, t, dh), None),
        (cross_k, (b, h, s, dh), None), (cross_v, (b, h, s, dh), None),
        (key_mask, (b, t), torch.int32), (cross_mask, (b, s), torch.int32)))
    _check_smem(name, _smem_layer_step(d, f, t, s))
    out = torch.empty_like(hidden)
    if b == 0:
        return out, cache_k, cache_v
    scratch = torch.empty(b, 10 * d + f, dtype=torch.float32, device=dev)
    arr = (_P * 27)(*ptrs, out.data_ptr(), scratch.data_ptr())
    _launch(f"cxr_fused_layer_step_{_SUFFIX[hidden.dtype]}", _ARGS_STEP, dev, arr, b, h, t, s, d,
            f, dh, int(index), 1.0 / math.sqrt(dh), float(eps))
    fused_layer_step.launches += 1
    return out, cache_k, cache_v


fused_layer_step.launches = 0
