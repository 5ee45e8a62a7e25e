"""Decode attention for one step against a cached K/V: three kernels and the
routing spec that chooses between them.

  * :func:`decode_attention` replaces
    ``cxrmate_tpu/ops/decode_attention.py:50 decode_attention`` (and its TPU
    blockings :98 and :149, the same function). The CUDA kernel
    (``csrc/decode_attention.cu``) keeps the contract's op order: fp32 scores,
    x scale, + the f32 additive mask, max-subtracted fp32 softmax, probs
    rounded to the input dtype before P.V, fp32 context.
  * :func:`decode_attention_vpu` replaces ``:221
    decode_attention_rowgroup_vpu``: the same contract from separate fp32
    multiplies and adds in one fixed order (``csrc/decode_attention_vpu.cu``).
  * :func:`decode_attention_q8` replaces ``:310
    decode_attention_rowgroup_q8``: attention over an int8 K/V cache made by
    :func:`quantize_kv_rowwise`, the per-key scales folded into the [M, S]
    scores and probs (``csrc/decode_attention_q8.cu``).

The three kernels are one body (``csrc/decode_split.cuh``): each (row,
head)'s keys are split over a thread-block cluster of up to 8 blocks, in one
launch; the split is :func:`decode_schedule`'s, a function of (S, dh) alone,
its 64-key tiles dealt to the blocks in turn, and keys whose mask is
finfo(float32).min are never read (for the int8 kernel neither their rows
nor their scales). Each source's note says what bounds the kernel on the
H100 and how its design meets that. On a CPU tensor a wrapper runs its
``*_plain`` version; on a CUDA tensor it launches the kernel or raises.

:func:`resolve_decode_kernel` is the port's copy of the JAX package's routing
grammar (``CXRMATE_DECODE_KERNEL``); ``models.bert.bert_step`` reads the
resolved spec.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Optional, Tuple

import torch

from cxrmate_torch.ops import _build

_C = {torch.float32: "cxr_decode_attention_f32", torch.bfloat16: "cxr_decode_attention_bf16"}
# q, k, v, mask, out; bh, heads, m, s, dh, n_split, chunk; scale, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_MAX_M = 4
KEY_TILE = 64  # keys: the unit S is cut into and dealt to a cluster's blocks
MAX_SPLIT = 8  # blocks of a cluster: the portable cluster size
# keys a block aims at: each block pays three cluster barriers and a few
# memory round trips whatever its length, so a short cache takes fewer,
# longer blocks (PERF.md: the beam-4 self calls)
TARGET_CHUNK = 256
_SPLIT_WARPS = 4  # warps of a split kernel's block
_SPLIT_RING = 2  # K/V tiles a split block has in flight (its shared-memory ring)
# dynamic shared memory of a split block: the limit less 1 KB of static
_SPLIT_SMEM_LIMIT = _SMEM_LIMIT - 1024


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's plain version: the eager-order attention of
    ``ops.layers.attention`` with a [B, S] mask."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + additive_mask.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def decode_schedule(s: int, dh: int) -> Tuple[int, int]:
    """How the three kernels split S keys: -> (n_split, chunk). S is cut
    into KEY_TILE-key tiles, dealt to the n_split blocks of a (row, head)'s
    cluster in turn (:func:`block_tiles`):
    as many blocks as keys need at about TARGET_CHUNK a block, at most
    MAX_SPLIT; chunk is the most keys a block holds, in whole tiles. It
    depends on (S, dh) alone, never on B, M or the card, so that the vpu
    kernel's summation order, and with it a row's bits, does not depend on
    the batch."""
    if dh != 64 or s < 1:
        raise ValueError(f"decode_schedule: needs dh = 64 and S >= 1, got dh={dh}, S={s}")
    tiles = -(-s // KEY_TILE)
    n_split = min(MAX_SPLIT, -(-s // TARGET_CHUNK))
    return n_split, -(-tiles // n_split) * KEY_TILE


def block_tiles(s: int, dh: int):
    """The tiles each block of :func:`decode_schedule` owns: block r the tiles
    r, r + n_split, r + 2 n_split, ... (tile t the keys [t * KEY_TILE, (t +
    1) * KEY_TILE) within S). Dealt in turn, a row's unmasked keys, which lie
    in a few contiguous ranges, spread evenly over the blocks."""
    n_split, _ = decode_schedule(s, dh)
    return [range(r, -(-s // KEY_TILE), n_split) for r in range(n_split)]


def smem_bytes(m: int, s: int, dh: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the split kernels for K/V of
    ``itemsize`` bytes (1: int8): the ring of K/V tiles in flight (later the
    per-warp [M, dh] fp32 partial contexts), the chunk's [M, chunk] fp32
    scores, the ranks' partials of the block's output elements, one mask bit
    per key, the list of tiles to read and, for int8, the chunk's fp32 V
    scales (``csrc/decode_split.cuh:smem_bytes``)."""
    _, chunk = decode_schedule(s, dh)
    ring = max(itemsize * _SPLIT_RING * KEY_TILE * dh, 4 * _SPLIT_WARPS * m * dh)
    return (ring + 4 * (m * chunk + m * dh + MAX_SPLIT) + 4 * (chunk // 32)
            + 4 * (chunk // KEY_TILE) + (4 * chunk if itemsize == 1 else 0))


def max_keys(m: int, dh: int, itemsize: int) -> int:
    """The largest S the split kernels take with M query rows and K/V of
    ``itemsize`` bytes (1: int8): MAX_SPLIT chunks of the longest chunk whose
    block fits in shared memory."""
    per = 1
    while smem_bytes(m, MAX_SPLIT * (per + 1) * KEY_TILE, dh, itemsize) <= _SPLIT_SMEM_LIMIT:
        per += 1
    return MAX_SPLIT * per * KEY_TILE


def _check_qkv(name: str, q, k, v, additive_mask, kv_dtype) -> Tuple[int, int, int, int, int]:
    """Reject what the three kernels do not take; -> (b, h, m, s, dh)."""
    req = _build.require
    req(q.is_cuda and all(t.device == q.device for t in (k, v, additive_mask)),
        lambda: f"{name}: q, k, v and the mask must be on one CUDA device")
    req(q.dtype in _C, lambda: f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    req(k.dtype == kv_dtype and v.dtype == kv_dtype,
        lambda: f"{name}: k and v must have dtype {kv_dtype}, got {k.dtype}, {v.dtype}")
    req(additive_mask.dtype == torch.float32, lambda: f"{name}: the mask must be float32")
    req(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
        and k.shape[:2] == q.shape[:2] and k.shape[3] == q.shape[3],
        lambda: f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, m, dh = q.shape
    s = k.shape[2]
    req(tuple(additive_mask.shape) == (b, s),
        lambda: f"{name}: mask shape {tuple(additive_mask.shape)} != {(b, s)}")
    req(dh == 64, lambda: f"{name}: needs head dim 64, got {dh}")
    req(1 <= m <= _MAX_M and s >= 1, lambda: f"{name}: needs 1 <= M <= {_MAX_M}, S >= 1")
    req(all(t.is_contiguous() for t in (q, k, v, additive_mask)),
        lambda: f"{name}: q, k, v and the mask must be contiguous")
    req(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
        lambda: f"{name}: q, k and v must be 16-byte aligned (16-byte vector loads)")
    return b, h, m, s, dh


def _launch_split(name: str, entries, q, k, v, additive_mask, scale,
                  scales=None) -> Tuple[torch.Tensor, bool]:
    """Check and launch one of the three split kernels (``entries``: its C
    entry per dtype; ``scales``: the int8 kernel's (kscale, vscale), whose K/V
    are int8); -> (the output, whether the kernel was launched: not for zero
    rows)."""
    req = _build.require
    b, h, m, s, dh = _check_qkv(name, q, k, v, additive_mask,
                                q.dtype if scales is None else torch.int8)
    if scales is not None:
        for sc in scales:
            req(sc.device == q.device and sc.dtype == torch.float32 and sc.is_contiguous()
                and tuple(sc.shape) == (b, h, 1, s),
                lambda: f"{name}: scales must be contiguous float32 {(b, h, 1, s)} on q's "
                f"device, got {sc.dtype} {tuple(sc.shape)}")
    e = k.element_size()
    req(smem_bytes(m, s, dh, e) <= _SPLIT_SMEM_LIMIT,
        lambda: f"{name}: S={s} exceeds the {max_keys(m, dh, e)} keys a cluster of "
        f"{MAX_SPLIT} blocks holds at M={m} with {k.dtype} K/V")
    out = torch.empty_like(q)
    if b * h == 0:
        return out, False
    n_split, chunk = decode_schedule(s, dh)
    entry = entries[q.dtype]
    if scales is None:
        fn = _build.kernel(entry, _ARGTYPES)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    else:
        fn = _build.kernel(entry, _ARGTYPES_Q8)
        ptrs = (q.data_ptr(), k.data_ptr(), scales[0].data_ptr(), v.data_ptr(),
                scales[1].data_ptr())
    with torch.cuda.device(q.device):
        err = fn(*ptrs, additive_mask.data_ptr(), out.data_ptr(), b * h, h, m, s, dh, n_split,
                 chunk, float(scale), _build.stream_of(q))
    _build.check(err, entry)
    return out, True


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, H, M, dh] vs cached k/v [B, H, S, dh] with a [B, S] fp32 additive
    key mask -> ctx [B, H, M, dh]. M is 1 (greedy) or the beam count."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, additive_mask, scale)
    out, launched = _launch_split("decode_attention", _C, q, k, v, additive_mask, scale)
    decode_attention.launches += launched
    return out


decode_attention.launches = 0


# ------------------------------------------------------- multiply-reduce (vpu)
_C_VPU = {torch.float32: "cxr_decode_attention_vpu_f32",
          torch.bfloat16: "cxr_decode_attention_vpu_bf16"}


def decode_attention_vpu_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The multiply-reduce kernel's plain version, the op order of
    ``_attn_kernel_rowgroup_vpu`` (:203-215): q, K, V cast to fp32, an
    elementwise product then a sum over dh, the exact softmax, probs rounded
    to the input dtype, an elementwise product then a sum over S. One query
    row at a time, so the [S, dh] products are the largest intermediate."""
    kf, vf = k.float(), v.float()
    rows = []
    for mi in range(q.shape[2]):
        scores = (kf * q[:, :, mi:mi + 1].float()).sum(-1)  # [B, H, S]
        scores = scores * scale + additive_mask.float()[:, None, :]
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        rows.append((probs.float()[..., None] * vf).sum(-2))  # [B, H, dh]
    return torch.stack(rows, dim=2).to(q.dtype)


def decode_attention_vpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The contract of :func:`decode_attention`, computed from separate fp32
    multiplies and adds in one fixed order: a row's output bits do not depend
    on the batch it is in, on M or on the launch."""
    if q.device.type == "cpu":
        return decode_attention_vpu_plain(q, k, v, additive_mask, scale)
    out, launched = _launch_split("decode_attention_vpu", _C_VPU, q, k, v, additive_mask,
                                  scale)
    decode_attention_vpu.launches += launched
    return out


decode_attention_vpu.launches = 0


# ------------------------------------------------------------ int8 K/V (q8)
_C_Q8 = {torch.float32: "cxr_decode_attention_q8_f32",
         torch.bfloat16: "cxr_decode_attention_q8_bf16"}
# q, kq, ks, vq, vs, mask, out; bh, heads, m, s, dh, n_split, chunk; scale, stream
_ARGTYPES_Q8 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def quantize_kv_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-key-row int8 quantisation of a cached K or V tensor
    (``cxrmate_tpu/ops/decode_attention.py:259``; plain tensor ops there too,
    run once per decode call).

    ``x`` [B, H, S, dh] -> (``q`` int8 [B, H, S, dh], ``scales`` f32
    [B, H, 1, S]) with ``scales = max|row| / 127`` (1.0 for all-zero rows) and
    ``q = clip(round_half_even(x / scales), -127, 127)``. Neither scale is
    ever multiplied back into the [S, dh] data: ``q . (kq ks) == (q . kq) ks``
    and ``probs . (vq vs) == (probs vs) . vq``, so both fold into [M, S]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)  # [B, H, S]
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scales[..., None]), -127, 127).to(torch.int8)
    return q, scales[:, :, None, :].contiguous()


def decode_attention_q8_plain(q: torch.Tensor, kq: torch.Tensor, kscale: torch.Tensor,
                              vq: torch.Tensor, vscale: torch.Tensor,
                              additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The int8 kernel's plain version, the op order of
    ``_attn_kernel_rowgroup_q8`` (:290-306): ``(q . kq) * ks`` in fp32, x
    scale, + mask, the exact softmax, then ``probs * vs`` rounded to q's dtype
    (the bare probs are not rounded first), fp32 context."""
    scores = torch.matmul(q.float(), kq.float().transpose(-1, -2)) * kscale
    scores = scores * scale + additive_mask.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * vscale).to(q.dtype)
    return torch.matmul(pv.float(), vq.float()).to(q.dtype)


def decode_attention_q8(q: torch.Tensor, kq: torch.Tensor, kscale: torch.Tensor,
                        vq: torch.Tensor, vscale: torch.Tensor,
                        additive_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q [B, H, M, dh] (float32 or bfloat16) vs an int8 cache kq/vq
    [B, H, S, dh] with fp32 per-key scales [B, H, 1, S] and a [B, S] fp32
    additive key mask -> ctx [B, H, M, dh] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_q8_plain(q, kq, kscale, vq, vscale, additive_mask, scale)
    out, launched = _launch_split("decode_attention_q8", _C_Q8, q, kq, vq, additive_mask, scale,
                                  (kscale, vscale))
    decode_attention_q8.launches += launched
    return out


decode_attention_q8.launches = 0


# -------------------------------------------------------------------- routing
# the routing grammar of CXRMATE_DECODE_KERNEL, as the JAX package accepts it:
# bare specs route all attention, the "cross-" prefix only the cross-attention,
# and q8 exists only in cross- form (the self cache is rewritten every step)
_KERNEL_SPEC_RE = re.compile(
    r"^(?:1|rowgrid|(?:vpu-)?rowgroup(?::\d+)?"
    r"|cross-(?:1|rowgrid|(?:vpu-)?rowgroup(?::\d+)?|rowgroup-q8(?::\d+)?))$"
)


def resolve_decode_kernel(spec: Optional[str] = None) -> str:
    """Resolve the decode-attention routing spec. ``None`` reads
    ``CXRMATE_DECODE_KERNEL`` at call time; ``""`` and ``"0"`` give ``""``; a
    spec outside the grammar raises ``ValueError`` (a near-miss must not run
    another kernel than the one meant).

    The hand-written kernels are the port's default, not an opt-in, so on the
    card the specs mean:

      ``""``, ``1``, ``rowgrid``, ``rowgroup[:G]`` and their ``cross-`` forms
          :func:`decode_attention` for self- and cross-attention (the TPU
          blockings are one function here);
      ``vpu-rowgroup[:G]``
          :func:`decode_attention_vpu` for both;
      ``cross-vpu-rowgroup[:G]``
          :func:`decode_attention` for self-, :func:`decode_attention_vpu`
          for cross-attention;
      ``cross-rowgroup-q8[:G]``
          :func:`decode_attention` for self-, :func:`decode_attention_q8`
          over the quantised cross cache for cross-attention (quantised
          numerics: serving only).

    ``:G`` is a TPU grid blocking (rows per grid cell): the grammar validates
    it and it has no effect on the card, where the blocking is the kernels'
    own: a cluster of :func:`decode_schedule`'s blocks per (row, head)."""
    if spec is None:
        spec = os.environ.get("CXRMATE_DECODE_KERNEL", "")
    if spec in ("", "0"):
        return ""
    if not _KERNEL_SPEC_RE.match(spec):
        raise ValueError(
            f"invalid CXRMATE_DECODE_KERNEL spec {spec!r}: expected one of "
            "'', '0', '1', 'rowgrid', 'rowgroup[:G]', 'vpu-rowgroup[:G]' "
            "(optionally 'cross-'-prefixed to route only the cross-attention) "
            "or 'cross-rowgroup-q8[:G]' (q8 requires the 'cross-' prefix)"
        )
    return spec


def is_q8(spec: str) -> bool:
    return spec.startswith("cross-rowgroup-q8")


def uses_vpu(spec: str, is_cross: bool) -> bool:
    """Whether a resolved spec sends this attention to the multiply-reduce
    kernel."""
    if spec.startswith("cross-"):
        return is_cross and spec[len("cross-"):].startswith("vpu-rowgroup")
    return spec.startswith("vpu-rowgroup")
