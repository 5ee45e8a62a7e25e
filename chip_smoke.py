#!/usr/bin/env python3
"""Drive the PyTorch port (cxrmate_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each printing one JSON line:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - builds the CUDA kernels from cxrmate_torch/csrc (nvcc, sm_90a).
  3. kernels - each of the five kernels against its plain PyTorch version on
               the card at every shape a main path below gives it (one table,
               main_path_calls, lists them: the multi, single and longitudinal
               calls, self caches 256 to 511 columns wide behind prompts whose
               pads are masked inside the key range, 8 and 32 rows), fp32 (TF32
               off, <= 1e-5) and bf16 (<= 1e-2), each decode kernel also with
               a fully masked row, the reorder bit-exact at the first, a
               middle and the last column; times of the kernel, the plain
               version, one PyTorch library call computing the same function
               (timed only, never used by the port) and the least time the
               card could take (bound). In bf16 the rounding points, which a
               tolerance cannot see, are held by bit shares: decode_attention
               must match its plain version more often than a version that
               skips rounding the probs, the int8 kernel more often than
               versions that round the probs before the V-scale fold or never.
               For the int8 kernel also integer-valued K/V (<= 2e-3) and its
               distance from exact attention on the unquantised K/V (max <
               0.1, RMS < 0.02). For the multiply-reduce kernel also the share
               of outputs bit-identical to its plain version and to
               decode_attention's kernel, and that a row's bits are the same
               alone and in its batch.
  4. main    - seeded random full-width models (CvT-21@384, BERT 6x768, the
               repository tokenizer's vocabulary) written as HF directories,
               loaded with CXRMate.from_hf_checkpoint and run through
               generate_report on 8 studies in bf16, one untimed call before
               the timed ones: multi (5 image slots, some all-zero), greedy
               and beam-4, three timed calls each; longitudinal (LoRA with a
               randomised lora_B, PEFT key names, synthetic previous reports
               whose prompts fall in the 64-, 128- and 256-token buckets, two
               studies without a previous report, one prompt truncated at 256)
               beam-4 with the default spec, beam-4 and greedy with
               cross-rowgroup-q8, greedy and beam-4 with vpu-rowgroup and one
               sampled call; single (one image per study), greedy and beam-4.
               studies/s, new tokens/s and ms per step of every call; each
               call's launch counts checked against the counts its path and
               spec imply.
  5. parity  - the whole path with the kernels against the same path with
               every kernel swapped for its plain version: encoder states,
               greedy decoder logits over a prefill and 16 teacher-fed steps,
               and beam-4 logits over 16 teacher-fed steps with the deferred
               write and the reorder; for the multi model and, with a padded
               prompt, for the longitudinal model under the default spec,
               vpu-rowgroup and cross-rowgroup-q8 (against the plain path over
               the same quantised cache); fp32 (TF32 off) held to 1e-3, bf16
               to 0.25; the greedy token agreement and the q8 path's distance
               from the unquantised path are printed.
Then the card's name and power limit, the kernels summary line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and the last line is not printed. The summary line has one row per
kernel and set of shapes, with the launches of the timed calls that ran the
kernel at those shapes.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STUDIES, SLOTS = 8, 5
IMAGES_PER_STUDY = (5, 4, 3, 2, 1, 5, 3, 2)  # the remaining slots are all-zero
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
# H100 SXM peaks: dense bf16 tensor cores; fp32 without tensor cores (TF32 off)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PARITY_TOL = 1e-3  # fp32 end to end: reassociation through 21 CvT + 6 decoder layers
# bf16 end to end: the kernel path against the plain path, same token feed;
# about 8x the 0.031 measured on an H100 (chip_smoke.py), to catch a broken
# kernel rather than bf16 rounding
BF16_PARITY_TOL = 0.25
MAIN_RUNS = 3  # timed generate_report calls per decoding mode
SMOKE_DIR = os.path.join(REPO, ".chip_smoke")
NEG = -3.4028234663852886e38  # finfo(float32).min, the additive mask of a masked key


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- timing
def time_ms(fns, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, cycling through ``fns`` (the same call on
    different inputs, so that a cache-sized input is not found in L2)."""
    import torch

    fns = list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time: the larger of bytes over the memory rate and operations
    over the peak rate for their type; and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- kernel checks
LAYERS, HEADS, HEAD_DIM = 6, 12, 64  # decoder layers; heads and their width
NEW_TOKENS = 255  # cache columns after the prompt: decoder_max_len - 1
COPIES = 4  # input sets a timing cycles through
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention": ("cxrmate_torch/csrc/flash_attention.cu",
                        "cxrmate_tpu/ops/flash_attention.py:60"),
    "decode_attention": ("cxrmate_torch/csrc/decode_attention.cu",
                         "cxrmate_tpu/ops/decode_attention.py:50"),
    "decode_attention_vpu": ("cxrmate_torch/csrc/decode_attention_vpu.cu",
                             "cxrmate_tpu/ops/decode_attention.py:221"),
    "decode_attention_q8": ("cxrmate_torch/csrc/decode_attention_q8.cu",
                            "cxrmate_tpu/ops/decode_attention.py:310"),
    "beam_reorder_write": ("cxrmate_torch/csrc/beam_reorder.cu",
                           "cxrmate_tpu/ops/beam_reorder.py:58"),
}
# (mode, beams, routing spec, longest prompt in tokens, the 32-token bucket the
# batch's prompts are padded to, sampling arguments): the longitudinal calls
LONGITUDINAL_RUNS = (
    ("beam4", 4, None, 300, 256, None),  # truncated at 256
    ("beam4-q8", 4, "cross-rowgroup-q8", 104, 128, None),
    ("greedy-q8", 1, "cross-rowgroup-q8", 44, 64, None),
    ("greedy-vpu", 1, "vpu-rowgroup", 200, 224, None),
    ("beam4-vpu", 4, "vpu-rowgroup", 44, 64, None),
    ("sampled", 1, None, 104, 128, {"top_k": 50, "top_p": 0.9}),
)


def main_path_calls(da):
    """What every timed main-path call of this script asks of the kernels:
    {(variant, mode): {"images": image slots per encode, "reorder_t": width of
    the self cache a beam step reorders (None for greedy), "decode": the self
    and the cross call of one decoder layer as (kernel, B, M, S, mask kind)}}.
    The self cache is prompt width + NEW_TOKENS columns wide. The kernels
    phase checks and times exactly these shapes; the summary line pairs each
    with the launches of the calls that gave the kernel that shape."""
    paths = {}
    for variant, s_cross, kind, images in (("multi", SLOTS * 576, "slots", STUDIES * SLOTS),
                                           ("single", 576, "open", STUDIES)):
        for mode, beams in (("greedy", 1), ("beam4", 4)):
            paths[(variant, mode)] = {
                "images": images, "reorder_t": 1 + NEW_TOKENS if beams > 1 else None,
                "decode": [("decode_attention", STUDIES * beams, 1, 1 + NEW_TOKENS, "prefix"),
                           ("decode_attention", STUDIES, beams, s_cross, kind)]}
    for mode, beams, spec, _, bucket, _ in LONGITUDINAL_RUNS:
        spec = da.resolve_decode_kernel(spec or "")
        t_len = bucket + NEW_TOKENS
        self_kernel = "decode_attention_vpu" if da.uses_vpu(spec, False) else "decode_attention"
        cross_kernel = ("decode_attention_q8" if da.is_q8(spec) else
                        "decode_attention_vpu" if da.uses_vpu(spec, True) else "decode_attention")
        paths[("longitudinal", mode)] = {
            "images": STUDIES * SLOTS, "reorder_t": t_len if beams > 1 else None,
            "decode": [(self_kernel, STUDIES * beams, 1, t_len, f"prompt:{bucket}"),
                       (cross_kernel, STUDIES, beams, SLOTS * 576, "slots")]}
    return paths


def key_mask(torch, kind, b, s):
    """The [b, s] additive key mask of a decode call mid-way through a run.
    ``slots``: the cross mask with the all-zero image slots masked; ``open``:
    nothing masked; ``prefix``: a self cache half written; ``prompt:P``: a
    self cache behind a prompt padded to P columns: each study's pads (from
    its true width to P; study 0 fills the bucket) are masked inside the key
    range, then 200 written columns, then the unwritten tail."""
    mask = torch.zeros(b, s, device="cuda")
    if kind == "slots":
        for i, n in enumerate(IMAGES_PER_STUDY):
            mask[i, n * 576:] = NEG
    elif kind == "prefix":
        mask[:, s // 2:] = NEG
    elif kind.startswith("prompt:"):
        bucket = int(kind.split(":")[1])
        study = torch.arange(b, device="cuda") // (b // STUDIES)
        width = torch.where(study == 0, bucket, 4 + (bucket - 4) * study // STUDIES)
        cols = torch.arange(s, device="cuda")
        pad = (cols[None, :] >= width[:, None]) & (cols[None, :] < bucket)
        mask[pad | (cols[None, :] >= bucket + 200)] = NEG
    elif kind != "open":
        raise ValueError(kind)
    return mask


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _mismatch(a, b) -> float:
    """Share of elements that are not bit-equal."""
    return float((a != b).float().mean())


def check_flash(torch, fa, F, dtype, n_img):
    """One encode of ``n_img`` images: the three CvT-21@384 stage shapes as
    (BH, Lq, Lk, calls per encode), summed over the encode's 21 calls."""
    shapes = [(n_img * 1, 9216, 2304, 1), (n_img * 3, 2304, 576, 4), (n_img * 6, 577, 145, 16)]
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
           "max_abs_err": 0.0, "per_shape": []}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for bh, lq, lk, calls in shapes:
        q = torch.randn(bh, lq, 64, generator=g, device="cuda").to(dtype)
        k = torch.randn(bh, lk, 64, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, lk, 64, generator=g, device="cuda").to(dtype)
        scale = (64 * (bh // n_img)) ** -0.5  # embed_dim ** -0.5, as CvT passes it
        got = fa.flash_attention(q, k, v, scale)
        want = fa.flash_attention_plain(q, k, v, scale)
        err = _err(got, want)
        del want
        ms = time_ms([lambda: fa.flash_attention(q, k, v, scale)])
        plain = time_ms([lambda: fa.flash_attention_plain(q, k, v, scale)], reps=3, warmup=1)
        lib = time_ms([lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=scale)])
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4.0 * bh * lq * lk * 64
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops)):
            out[key] += calls * val
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["per_shape"].append({"bh": bh, "lq": lq, "lk": lk, "calls": calls, "ms": ms,
                                 "plain_ms": plain, "library_ms": lib, "max_abs_err": err})
        del q, k, v, got
    return out


def decode_work(kernel, q, mask):
    """Bytes and operations a decode-attention call needs on these inputs: q,
    the output, the mask, and K and V of the unmasked keys only (a key under
    finfo(f32).min gets probability exactly 0 and cannot change the output).
    A key costs two rows of q's type, or for the int8 kernel two int8 rows and
    two fp32 scales."""
    b, h, m, dh = q.shape
    keys = float((mask == 0).sum())  # unmasked (row, key) pairs
    e = q.element_size()
    per_key = 2 * dh + 8 if kernel == "decode_attention_q8" else 2 * dh * e
    return 2 * q.numel() * e + keys * h * per_key + mask.numel() * 4, 4.0 * keys * h * m * dh


def _softmax_scores(q, k, mask, scale):
    return ((q.float() @ k.float().transpose(-1, -2)) * scale + mask[:, None, None, :]).softmax(-1)


def extras_decode(torch, da, dtype, args, floats, mask, got, want, g):
    """bf16: the kernel must agree bit for bit with the plain version more
    often than with a version that keeps the probs in fp32 before P.V (what a
    kernel that skipped the contract's rounding would compute)."""
    if dtype != torch.bfloat16:
        return {}
    q, k, v = args
    unrounded = (_softmax_scores(q, k, mask, 0.125) @ v.float()).to(dtype)
    out = {"mismatch_share": _mismatch(got, want),
           "mismatch_share_unrounded": _mismatch(got, unrounded)}
    if not out["mismatch_share"] < out["mismatch_share_unrounded"]:
        raise AssertionError(f"decode_attention bf16 {out}: the probs do not look rounded to "
                             "bf16 before P.V")
    return out


def extras_q8(torch, da, dtype, args, floats, mask, got, want, g):
    """The int8 kernel's own checks: its distance from exact attention on the
    unquantised K/V; in fp32 integer-valued K/V; in bf16 the rounding point
    (probs x vs rounded once, after the fold), which only bit shares can see:
    the kernel must match the plain version more often than a version that
    rounds the bare probs before the fold and than one that never rounds."""
    q, kq, ks, vq, vs = args
    b, h, m, dh = q.shape
    s = kq.shape[2]
    exact = da.decode_attention_plain(q.float(), *floats, mask, 0.125)
    qerr = (got.float() - exact).abs()
    out = {"vs_unquantised": {"max": float(qerr.max()), "rms": float(qerr.pow(2).mean().sqrt())}}
    if not (out["vs_unquantised"]["max"] < 0.1 and out["vs_unquantised"]["rms"] < 0.02):
        raise AssertionError(f"decode_attention_q8 M={m}: quantisation error {out}")
    if dtype == torch.float32:
        # integer-valued K/V (every scale exactly 1): 2e-3 absolute at the
        # +-127 value range, as the JAX package's own test holds it
        ki = torch.randint(-127, 128, (b, h, s, dh), generator=g, device="cuda").float()
        vi = torch.randint(-127, 128, (b, h, s, dh), generator=g, device="cuda").float()
        ki[..., 0] = vi[..., 0] = 127.0
        kqi, ksi = da.quantize_kv_rowwise(ki)
        vqi, vsi = da.quantize_kv_rowwise(vi)
        if not (bool((ksi == 1).all()) and bool((vsi == 1).all())):
            raise AssertionError("quantize_kv_rowwise: integer rows must get scale 1")
        qi = q * 0.05  # keeps the softmax from collapsing onto one key
        out["integer_kv_err"] = _err(da.decode_attention_q8(qi, kqi, ksi, vqi, vsi, mask, 0.125),
                                     da.decode_attention_plain(qi, ki, vi, mask, 0.125))
        if not out["integer_kv_err"] <= 2e-3:
            raise AssertionError(f"decode_attention_q8 fp32 M={m}: integer-valued K/V {out}")
        return out
    scores = torch.matmul(q.float(), kq.float().transpose(-1, -2)) * ks
    probs = (scores * 0.125 + mask[:, None, None, :]).softmax(-1)
    early = torch.matmul(probs.to(dtype).float() * vs, vq.float()).to(dtype)
    never = torch.matmul(probs * vs, vq.float()).to(dtype)
    out.update(mismatch_share=_mismatch(got, want),
               mismatch_share_probs_rounded_before_fold=_mismatch(got, early),
               mismatch_share_unrounded=_mismatch(got, never))
    if not out["mismatch_share"] < min(out["mismatch_share_probs_rounded_before_fold"],
                                       out["mismatch_share_unrounded"]):
        raise AssertionError(f"decode_attention_q8 bf16 M={m} {out}: probs x vs does not look "
                             "rounded to bf16 once, after the V-scale fold")
    return out


def extras_vpu(torch, da, dtype, args, floats, mask, got, want, g):
    """The multiply-reduce kernel's verdict: the share of outputs bit-identical
    to its plain version and to decode_attention's kernel (printed), and each
    row's bits alone against the same row inside the batch (held)."""
    q, k, v = args
    alone = torch.cat([da.decode_attention_vpu(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                               mask[i:i + 1], 0.125) for i in range(q.shape[0])])
    out = {"bit_identical_to_plain": 1.0 - _mismatch(got, want),
           "bit_identical_to_decode_attention": 1.0 - _mismatch(
               got, da.decode_attention(q, k, v, mask, 0.125)),
           "alone_equals_in_batch": bool(torch.equal(alone, got))}
    if not out["alone_equals_in_batch"]:
        raise AssertionError(f"decode_attention_vpu {tuple(q.shape)}: a row's bits depend on "
                             "its batch")
    return out


EXTRAS = {"decode_attention": extras_decode, "decode_attention_q8": extras_q8,
          "decode_attention_vpu": extras_vpu}


def check_decode_call(torch, da, F, g, dtype, kernel, b, m, s, kind):
    """One decode-attention call shape of a main path: the kernel against its
    plain version, also with row 0 fully masked (the uniform softmax, finite),
    the kernel's own extra checks, and the times of the kernel, the plain
    version and the library call (SDPA; for the int8 kernel the dequantise
    too, which a library user would pay)."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    run, plain = getattr(da, kernel), getattr(da, kernel + "_plain")
    mask = key_mask(torch, kind, b, s)
    bool_mask = (mask == 0)[:, None, None, :]
    sets, floats = [], None
    for _ in range(COPIES):
        q = torch.randn(b, HEADS, m, HEAD_DIM, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, HEADS, s, HEAD_DIM, generator=g, device="cuda")
        v = torch.randn(b, HEADS, s, HEAD_DIM, generator=g, device="cuda")
        if kernel == "decode_attention_q8":
            sets.append((q, *da.quantize_kv_rowwise(k), *da.quantize_kv_rowwise(v)))
            floats = floats or (k, v)
        else:
            sets.append((q, k.to(dtype), v.to(dtype)))
    args = sets[0]
    got = run(*args, mask, 0.125)
    want = plain(*args, mask, 0.125)
    dark = mask.clone()
    dark[0] = NEG
    got_dark = run(*args, dark, 0.125)
    err_dark = _err(got_dark, plain(*args, dark, 0.125))
    if not (bool(torch.isfinite(got_dark.float()).all()) and err_dark <= tol):
        raise AssertionError(f"{kernel} {dtype} {(b, m, s, kind)}: fully masked row, "
                             f"err {err_dark}")
    out = {"b": b, "m": m, "s": s, "mask": kind, "max_abs_err": _err(got, want),
           "fully_masked_row_err": err_dark,
           **EXTRAS[kernel](torch, da, dtype, args, floats, mask, got, want, g)}

    def library(q, k, v, *rest):
        if rest:  # int8 (q, kq, ks, vq, vs): dequantise first
            kq, ks, vq, vs = k, v, *rest
            k = kq.to(q.dtype) * ks.transpose(-1, -2).to(q.dtype)
            v = vq.to(q.dtype) * vs.transpose(-1, -2).to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask, scale=0.125)

    out["ms"] = time_ms([lambda a=a: run(*a, mask, 0.125) for a in sets])
    out["plain_ms"] = time_ms([lambda a=a: plain(*a, mask, 0.125) for a in sets], reps=5, warmup=1)
    out["library_ms"] = time_ms([lambda a=a: library(*a) for a in sets])
    out["bytes"], out["flops"] = decode_work(kernel, args[0], mask)
    return out


def reorder_work(cache, sel, index, beams) -> float:
    """Bytes the in-place reorder of K and V needs on these inputs: a row that
    takes another beam's row is read from its source and written whole; a row
    that keeps its own (sel[j] == j) only gets the new column, if any."""
    import torch

    r, h, t_len, dh = cache.shape
    e = cache.element_size()
    local = torch.arange(r, device=sel.device) % beams
    moved = int((sel.long() != local).sum())
    kept = r - moved
    row, col = h * t_len * dh * e, h * dh * e
    per_cache = moved * 2 * row + (kept * 2 * col if index >= 0 else 0)
    return 2 * per_cache + sel.numel() * 4


def check_reorder(torch, br, dtype, t_len):
    """One in-place reorder of the [32, 12, t_len, 64] self K/V cache of
    STUDIES studies x 4 beams with the step's column written: bit-exact
    against the plain version at a middle, the first and the last column and
    without a write; timed at column 100."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r, beams = STUDIES * 4, 4

    def inputs():
        ck = torch.randn(r, HEADS, t_len, HEAD_DIM, generator=g, device="cuda").to(dtype)
        cv = torch.randn(r, HEADS, t_len, HEAD_DIM, generator=g, device="cuda").to(dtype)
        nk = torch.randn(r, HEADS, HEAD_DIM, generator=g, device="cuda").to(dtype)
        nv = torch.randn(r, HEADS, HEAD_DIM, generator=g, device="cuda").to(dtype)
        return ck, cv, nk, nv

    sel = torch.randint(0, beams, (r,), generator=g, device="cuda", dtype=torch.int32)
    sel[:beams] = torch.tensor([1, 1, 0, 1], dtype=torch.int32)  # repeated sources
    exact = True
    for index in (100, 0, t_len - 1, -1):
        ck, cv, nk, nv = inputs()
        a, b = ck.clone(), cv.clone()
        br.beam_reorder_write(ck, cv, nk, nv, sel, index, beams)
        br.beam_reorder_write_plain(a, b, nk, nv, sel, index, beams)
        exact &= torch.equal(ck, a) and torch.equal(cv, b)
    sets = [inputs() for _ in range(COPIES)]
    src = torch.arange(r, device="cuda") // beams * beams + sel.long()
    col = torch.tensor([100], device="cuda")

    def library(ck, cv, nk, nv):  # index_select + index_copy_
        for cache, new in ((ck, nk), (cv, nv)):
            out = cache.index_select(0, src)
            out.index_copy_(2, col, new.index_select(0, src)[:, :, None])

    return {"t": t_len, "exact": exact, "max_abs_err": 0.0 if exact else float("inf"),
            "ms": time_ms([lambda a=a: br.beam_reorder_write(*a, sel, 100, beams) for a in sets]),
            "plain_ms": time_ms([lambda a=a: br.beam_reorder_write_plain(*a, sel, 100, beams)
                                 for a in sets]),
            "library_ms": time_ms([lambda a=a: library(*a) for a in sets]),
            "bytes": reorder_work(sets[0][0], sel, 100, beams), "flops": 0.0}


def kernel_phase(torch, F, fa, da, br):
    """Each kernel against its plain version at every shape a main path gives
    it (main_path_calls), fp32 (TF32 off) then bf16. -> {dtype: {"flash":
    {images: result}, "decode": {call: result}, "reorder": {width: result}}},
    each result per encode (flash) or per call."""
    from cxrmate_torch.utils.precision import parity_mode

    paths = main_path_calls(da).values()
    images = sorted({p["images"] for p in paths}, reverse=True)
    calls = sorted({c for p in paths for c in p["decode"]})
    widths = sorted({p["reorder_t"] for p in paths if p["reorder_t"]})
    results = {}
    for name, dtype, tol in (("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 1e-2)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        with parity_mode():
            res = {"flash": {n: check_flash(torch, fa, F, dtype, n) for n in images},
                   "decode": {c: check_decode_call(torch, da, F, g, dtype, *c) for c in calls},
                   "reorder": {t: check_reorder(torch, br, dtype, t) for t in widths}}
        checked = ([("flash_attention", {"images": n, **r}) for n, r in res["flash"].items()]
                   + [(c[0], r) for c, r in res["decode"].items()]
                   + [("beam_reorder_write", r) for r in res["reorder"].values()])
        for kname, r in checked:
            bound, bound_by = bound_ms(r["bytes"], r["flops"], name)
            emit({"phase": "kernels", "dtype": name, "kernel": kname, "tolerance": tol,
                  "bound_ms": bound, "bound_by": bound_by,
                  **{k: v for k, v in r.items() if k not in ("bytes", "flops")}})
            if not r["max_abs_err"] <= tol:
                raise AssertionError(f"{kname} {name} {r}: max abs err > {tol}")
        results[name] = res
    return results


# ------------------------------------------------------------------ main path
class Recorder:
    """Counts the calls of module-level functions the main path goes through
    (bert_step, the encoder, the decoders), keeps the decoders' outputs, and
    adds up the wall time of the timed ones (synchronised on both sides)."""

    def __init__(self):
        self.calls, self.outputs, self.seconds = {}, {}, {}
        self._undo = []

    def wrap(self, module, name, keep=False, timed=False):
        import torch

        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*a, **kw)
            if timed:
                torch.cuda.synchronize()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            if keep:
                self.outputs[name] = out
            return out

        setattr(module, name, wrapped)
        self._undo.append((module, name, fn))

    def restore(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version (the parity oracle)."""
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa

    swaps = [(fa, "flash_attention"), (da, "decode_attention"), (da, "decode_attention_vpu"),
             (da, "decode_attention_q8"), (br, "beam_reorder_write")]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def make_pixels(np):
    rs = np.random.RandomState(SEED)
    px = rs.randn(STUDIES, SLOTS, 3, 384, 384).astype(np.float32)
    for i, n in enumerate(IMAGES_PER_STUDY):
        px[i, n:] = 0.0
    return px


def write_checkpoint(torch, api, tokenizer_path, variant):
    """A seeded random full-width model as an HF directory, under the released
    checkpoints' key names. The longitudinal one gets a random lora_B (a
    fresh LoRA's is zero, which would leave LoRA inert)."""
    from cxrmate_torch.ckpt.hf import model_state_dict, save_hf_pretrained_dir
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer.from_file(tokenizer_path)
    model = api.CXRMate.random_init(tok, variant=variant, dtype=torch.float32, seed=SEED,
                                    device="cuda")
    if variant == "longitudinal":
        g = torch.Generator(device="cuda").manual_seed(SEED + 6)
        with torch.no_grad():
            for name, p in model.model.named_parameters():
                if ".lora_B." in name:
                    p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
    sd = model_state_dict(model.model)
    if variant == "longitudinal" and not any(
            k.startswith("decoder.base_model.model.") and ".lora_B.default." in k for k in sd):
        raise AssertionError("the longitudinal checkpoint lacks PEFT key names")
    path = os.path.join(SMOKE_DIR, f"cxrmate-{variant}-random")
    save_hf_pretrained_dir(path, sd, model.config)
    shutil.copy(tokenizer_path, os.path.join(path, "tokenizer.json"))
    return path


def synthetic_section(tok, rs, n_tokens):
    """A string decoded from random token ids whose encoding has about
    ``n_tokens`` tokens (grown four ids at a time: decoding then encoding
    does not keep the count)."""
    special = {tok.vocab[t] for t in tok.all_special_tokens}
    ordinary = [i for i in range(len(tok)) if i not in special]
    text = ""
    while len(tok.encode(text)) < n_tokens:
        text += tok.decode([ordinary[j] for j in rs.randint(0, len(ordinary), 4)])
    return text


def make_prompts(np, tok, longest, seed):
    """Previous reports for STUDIES studies: studies 1 and 6 have none
    ([NPF]/[NPI]), the others' prompts are spread up to ``longest`` tokens
    (study 0 the longest; above the 256-token limit it is truncated)."""
    rs = np.random.RandomState(seed)
    findings, impression = [], []
    for i in range(STUDIES):
        if i in (1, 6):
            findings.append(None)
            impression.append(None)
            continue
        total = longest if i == 0 else max(8, int(longest * rs.uniform(0.2, 0.8)))
        body = total - 3  # [PMT], [PMT-SEP] and [BOS]
        findings.append(synthetic_section(tok, rs, body * 2 // 3))
        impression.append(synthetic_section(tok, rs, body - body * 2 // 3))
    return findings, impression


def new_tokens(seqs, eos) -> int:
    """Tokens generated, each row counted up to and including its EOS."""
    total = 0
    for row in seqs:
        hits = (row == eos).nonzero()[0]
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def drive(model, px, mode, beams, depth, layers, spec=None, prompts=None, sample=None):
    """One generate_report call, a main path, with every launch count set to
    0 just before it and read just after; checks the counts against what the
    path and the routing spec imply, checks the output, and returns the
    call's figures."""
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    import torch

    tok = model.tokenizer
    kw = dict(num_beams=beams, decode_kernel=spec)
    p_len = 1
    if prompts is not None:
        kw.update(previous_findings=prompts[0], previous_impression=prompts[1])
        width = model.tokenize_prompt(*prompts, add_bos_token_id=True)["input_ids"].shape[1]
        p_len = -(-width // 32) * 32
    if sample is not None:
        kw.update(do_sample=True, **sample,
                  generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
    wrappers = {"flash_attention": fa.flash_attention, "decode_attention": da.decode_attention,
                "decode_attention_q8": da.decode_attention_q8,
                "decode_attention_vpu": da.decode_attention_vpu,
                "beam_reorder_write": br.beam_reorder_write}
    rec = Recorder()
    rec.wrap(bert_mod, "bert_step")
    rec.wrap(ed, "encode_images", timed=True)
    rec.wrap(api, "beam_search" if beams > 1 else "generate", keep=True)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        findings, impression = model.generate_report(px, **kw)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    steps = rec.calls.get("bert_step", 0)
    per_kind = layers * steps  # self calls per decode, and as many cross calls
    spec = spec or ""
    want = {"flash_attention": depth, "decode_attention": 2 * per_kind, "decode_attention_q8": 0,
            "decode_attention_vpu": 0,
            "beam_reorder_write": layers * (steps + 1) if beams > 1 else 0}
    if da.is_q8(spec):
        want.update(decode_attention=per_kind, decode_attention_q8=per_kind)
    elif da.uses_vpu(spec, False):
        want.update(decode_attention=0, decode_attention_vpu=2 * per_kind)
    if launches != want or steps == 0:
        raise AssertionError(f"{mode}: launches {launches}, expected {want} ({steps} steps)")
    out = rec.outputs["beam_search" if beams > 1 else "generate"]
    seqs = (out[0] if beams > 1 else out).cpu().numpy()
    if not (len(findings) == len(impression) == STUDIES
            and all(isinstance(s, str) for s in findings + impression)):
        raise AssertionError(f"{mode}: malformed reports")
    if seqs.shape != (STUDIES, p_len + model.config.decoder_max_len - 1) or \
            not ((seqs >= 0) & (seqs < len(tok))).all():
        raise AssertionError(f"{mode}: sequences {seqs.shape} out of range")
    ntok = new_tokens(seqs[:, p_len:], tok.eos_token_id)
    enc_s = rec.seconds["encode_images"]
    return {"seconds": secs, "studies_per_s": STUDIES / secs, "new_tokens_per_s": ntok / secs,
            "new_tokens": ntok, "encode_s": enc_s, "decode_s": secs - enc_s,
            "decode_ms_per_step": (secs - enc_s) / steps * 1e3, "decode_steps": steps,
            "prompt_width": p_len, "launches": launches, "first_findings": findings[0][:80]}


def main_phase(torch, np, ckpt):
    """The multi path. Each mode: one untimed call at the timed shapes (full
    length: cuBLAS handles, allocator growth), then MAIN_RUNS timed calls; the
    median call's figures are reported beside every call's studies/s."""
    from cxrmate_torch.models import api

    t0 = time.perf_counter()
    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.bfloat16,
                                           device="cuda")
    load_s = time.perf_counter() - t0
    px = make_pixels(np)
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    results, counts = {}, {}
    for mode, beams in (("greedy", 1), ("beam4", 4)):
        model.generate_report(px, num_beams=beams)  # warm-up, untimed
        runs = [drive(model, px, mode, beams, depth, layers) for _ in range(MAIN_RUNS)]
        med = sorted(runs, key=lambda r: r["studies_per_s"])[MAIN_RUNS // 2]
        results[mode] = {**med, "runs_studies_per_s": [r["studies_per_s"] for r in runs],
                         "runs_decode_ms_per_step": [r["decode_ms_per_step"] for r in runs],
                         "checkpoint_load_s": load_s}
        counts[mode] = med["launches"]
        emit({"phase": "main", "variant": "multi", "mode": mode, "dtype": "bf16",
              "studies": STUDIES, "image_slots": SLOTS, "runs": MAIN_RUNS, "reported": "median",
              **results[mode]})
    return results, counts


def longitudinal_phase(torch, np, ckpt):
    """The longitudinal path at full width: per run one untimed call, then one
    timed call with its launch counts checked."""
    from cxrmate_torch.models import api

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="longitudinal", dtype=torch.bfloat16,
                                           device="cuda")
    if model.config.lora is None:
        raise AssertionError("the longitudinal checkpoint loaded without LoRA")
    tok = model.tokenizer
    px = make_pixels(np)
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    counts, widths = {}, set()
    for n, (mode, beams, spec, longest, bucket, sample) in enumerate(LONGITUDINAL_RUNS):
        prompts = make_prompts(np, tok, longest, SEED + 10 + n)
        ids = model.tokenize_prompt(*prompts, add_bos_token_id=True)["input_ids"]
        if longest > model.config.prompt_max_len and not (
                ids.shape[1] == model.config.prompt_max_len and ids[0, -1] == tok.bos_token_id):
            raise AssertionError(f"{mode}: the long prompt was not truncated with BOS forced")
        if not (ids[1, 1] == tok.vocab["[NPF]"] and ids[6, 3] == tok.vocab["[NPI]"]):
            raise AssertionError(f"{mode}: a study without a previous report lacks [NPF]/[NPI]")
        warm = dict(previous_findings=prompts[0], previous_impression=prompts[1],
                    num_beams=beams, decode_kernel=spec)
        if sample is not None:
            warm.update(do_sample=True, **sample,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        model.generate_report(px, **warm)  # warm-up, untimed
        res = drive(model, px, f"longitudinal {mode}", beams, depth, layers, spec=spec,
                    prompts=prompts, sample=sample)
        if res["prompt_width"] != bucket:  # the kernels phase checked this run's shapes
            raise AssertionError(f"{mode}: prompt bucket {res['prompt_width']}, expected {bucket}")
        widths.add(bucket)
        counts[mode] = res["launches"]
        emit({"phase": "main", "variant": "longitudinal", "mode": mode, "dtype": "bf16",
              "decode_kernel": spec or "", "studies": STUDIES, "image_slots": SLOTS,
              "runs": 1, **res})
    if not {64, 128, 256} <= widths:
        raise AssertionError(f"prompt buckets {sorted(widths)} miss one of 64, 128, 256")
    return counts


def single_phase(torch, np, ckpt):
    """The single-image path: [STUDIES, 3, 384, 384], greedy and beam-4, one
    untimed then one timed call each. The multi checkpoint serves: the two
    variants hold the same tensors."""
    from cxrmate_torch.models import api

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="single", dtype=torch.bfloat16,
                                           device="cuda")
    px = make_pixels(np)[:, 0]
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    counts = {}
    for mode, beams in (("greedy", 1), ("beam4", 4)):
        model.generate_report(px, num_beams=beams)  # warm-up, untimed
        res = drive(model, px, f"single {mode}", beams, depth, layers)
        counts[mode] = res["launches"]
        emit({"phase": "main", "variant": "single", "mode": mode, "dtype": "bf16",
              "studies": STUDIES, "image_slots": 1, "runs": 1, **res})
    return counts


def teacher_fed(torch, model, gen_cfg, px, prompt, col, spec, beam_feed, beam_sel, beams, steps,
                tokens=None):
    """Encoder states, greedy logits (prefill, then ``steps`` - 1 teacher-fed
    bert_step calls with the cache written) and beam logits (bert_step with
    the write deferred, then the reorder with the given beam choices) of one
    path under one routing spec. ``tokens`` feeds the greedy steps; without
    it the path's own free-running greedy output does."""
    from cxrmate_torch.generate.decode import generate, prefill
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops.decode_attention import resolve_decode_kernel

    spec = resolve_decode_kernel(spec)
    n, p_len = prompt.shape
    t_total = p_len + steps
    cols = torch.arange(t_total, device="cuda")
    masked = gen_cfg.mask_token_id is not None
    dec = model.model.decoder

    def step_inputs(feed, i):
        upto = cols <= i
        if masked:
            key_mask = ((feed != gen_cfg.mask_token_id) & upto).int()
            pos = (key_mask.sum(1) - 1).clamp(min=0)
        else:
            key_mask = upto.int().expand(feed.shape[0], t_total).contiguous()
            pos = torch.full((feed.shape[0],), i, dtype=torch.long, device="cuda")
        return key_mask, pos, torch.zeros(feed.shape[0], dtype=torch.int32, device="cuda")

    hidden, mask = ed.encode_images(model.model, px)
    seq = generate(model.model, gen_cfg, hidden, mask, prompt, None, prompt_logits_col=col,
                   decode_kernel=spec)
    feed = seq if tokens is None else tokens
    logits0, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
    cache, q8 = bert_mod.maybe_quantize_cross_cache(cache, spec)
    greedy = [logits0[:, p_len - 1 if col is None else col]]
    for i in range(p_len, t_total - 1):
        key_mask, pos, ttype = step_inputs(feed, i)
        logits, cache = bert_mod.bert_step(dec, cache, feed[:, i], ttype, pos, i, key_mask, mask,
                                           decode_kernel=spec, cross_q8=q8)
        greedy.append(logits)
    _, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
    cache.self_k = [x.repeat_interleave(beams, 0) for x in cache.self_k]
    cache.self_v = [x.repeat_interleave(beams, 0) for x in cache.self_v]
    cache, q8 = bert_mod.maybe_quantize_cross_cache(cache, spec)
    beam = []
    for i in range(p_len, t_total - 1):
        key_mask, pos, ttype = step_inputs(beam_feed, i)
        logits, (nk, nv) = bert_mod.bert_step(dec, cache, beam_feed[:, i], ttype, pos, i, key_mask,
                                              mask, deferred_write=True, decode_kernel=spec,
                                              cross_q8=q8)
        for li in range(len(cache.self_k)):
            br.beam_reorder_write(cache.self_k[li], cache.self_v[li], nk[li], nv[li],
                                  beam_sel[i], i, beams)
        beam.append(logits)
    return hidden, torch.stack(greedy, 1), torch.stack(beam, 1), seq


def parity_phase(torch, np, ckpts):
    """The kernel path against the plain path on the card, on the same token
    sequences, for the multi model and (with a ragged prompt padded to its
    32-token bucket) the longitudinal model under the default spec,
    vpu-rowgroup and cross-rowgroup-q8; the q8 plain path runs over the same
    quantised cache. fp32 with TF32 off is held to PARITY_TOL, bf16 (the
    serving dtype) to BF16_PARITY_TOL; both must be finite. The q8 path's
    distance from the unquantised path (same tokens) is printed, not held."""
    from cxrmate_torch.models import api
    from cxrmate_torch.utils.precision import parity_mode

    n, beams, steps = 2, 4, 16
    pixels = torch.from_numpy(make_pixels(np)[:n]).cuda()
    cases = [("multi", None), ("longitudinal", None), ("longitudinal", "vpu-rowgroup"),
             ("longitudinal", "cross-rowgroup-q8")]
    results = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        px = pixels.to(dtype)
        models = {}
        for variant, spec in cases:
            with parity_mode(), torch.no_grad():
                if variant not in models:
                    models.clear()  # one model on the card at a time
                    models[variant] = api.CXRMate.from_hf_checkpoint(
                        ckpts[variant], variant=variant, dtype=dtype, device="cuda")
                model = models[variant]
                tok = model.tokenizer
                gen_cfg = model._gen_cfg(1, steps)
                g = torch.Generator().manual_seed(SEED + 3)  # the same tokens each dtype
                if variant == "multi":
                    prompt = torch.full((n, 1), tok.bos_token_id, dtype=torch.int32,
                                        device="cuda")
                    col = None
                else:  # true widths 21 and 9 in the 32-token bucket
                    prompt = torch.full((n, 32), tok.pad_token_id, dtype=torch.int32)
                    for r, w in enumerate((21, 9)):
                        row = torch.randint(10, len(tok), (w,), generator=g).int()
                        row[0], row[w // 2], row[-1] = (tok.vocab["[PMT]"],
                                                        tok.vocab["[PMT-SEP]"], tok.bos_token_id)
                        prompt[r, :w] = row
                    prompt, col = prompt.cuda(), 20
                t_total = prompt.shape[1] + steps
                beam_feed = torch.randint(0, len(tok), (n * beams, t_total), generator=g).int()
                beam_feed[:, :prompt.shape[1]] = prompt.cpu().repeat_interleave(beams, 0)
                beam_feed = beam_feed.cuda()
                beam_sel = torch.randint(0, beams, (t_total, n * beams), generator=g).int().cuda()
                args = (torch, model, gen_cfg, px, prompt, col, spec, beam_feed, beam_sel, beams,
                        steps)
                h_k, g_k, b_k, seq_k = teacher_fed(*args)
                with plain_kernels():
                    h_p, g_p, b_p, seq_p = teacher_fed(*args, tokens=seq_k)
                extra = {}
                if spec == "cross-rowgroup-q8":
                    _, g_u, b_u, _ = teacher_fed(*args[:6], None, *args[7:], tokens=seq_k)
                    extra = {"q8_vs_unquantised_greedy_logits": _err(g_k, g_u),
                             "q8_vs_unquantised_beam4_logits": _err(b_k, b_u)}
                torch.cuda.synchronize()
            res = {"encoder_max_abs_err": _err(h_k, h_p),
                   "greedy_logits_max_abs_err": _err(g_k, g_p),
                   "beam4_logits_max_abs_err": _err(b_k, b_p), "steps": g_k.shape[1],
                   "greedy_token_agreement": float((seq_k == seq_p).float().mean()),
                   "finite": bool(all(torch.isfinite(x.float()).all() for x in (h_k, g_k, b_k))),
                   **extra}
            res["tolerance"] = PARITY_TOL if name == "fp32" else BF16_PARITY_TOL
            emit({"phase": "parity", "dtype": name, "variant": variant,
                  "decode_kernel": spec or "", **res})
            errs = [v for k, v in res.items() if k.endswith("max_abs_err")]
            if not (res["finite"] and max(errs) <= res["tolerance"]):
                raise AssertionError(f"{name} {variant} {spec}: kernel path disagrees with the "
                                     f"plain path: {res}")
            results[(name, variant, spec)] = res
        del models
    return results


def kernels_line(da, k, counts):
    """The summary, bf16 (the serving dtype). One row per kernel and per set
    of shapes a main path gives it: times and bound of one unit of that work
    (one encode for flash; one decode step for the others: LAYERS times the
    path's calls to the kernel), beside the launches of the timed main-path
    calls that ran the kernel at exactly those shapes."""
    bf = k["bf16"]
    rows = {}  # (kernel, shapes) -> [paths, launches, [(result, times per unit)]]

    def add(kernel, shapes, path, parts):
        row = rows.setdefault((kernel, shapes), [[], 0, parts])
        row[0].append(" ".join(path))
        row[1] += counts[path[0]][path[1]][kernel]

    for path, p in main_path_calls(da).items():
        add("flash_attention", p["images"], path, [(bf["flash"][p["images"]], 1)])
        if p["reorder_t"]:
            add("beam_reorder_write", p["reorder_t"], path,
                [(bf["reorder"][p["reorder_t"]], LAYERS)])
        for kernel in sorted({c[0] for c in p["decode"]}):
            calls = tuple(c for c in p["decode"] if c[0] == kernel)
            add(kernel, calls, path, [(bf["decode"][c], LAYERS) for c in calls])
    out = []
    for (kernel, shapes), (paths, launches, parts) in rows.items():
        total = {key: sum(n * r[key] for r, n in parts)
                 for key in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
        b, by = bound_ms(total["bytes"], total["flops"], "bf16")
        if launches <= 0:
            raise AssertionError(f"{kernel} {shapes}: not launched on any main path")
        if kernel == "flash_attention":
            work = f"one encode of {shapes} images"
        elif kernel == "beam_reorder_write":
            work = f"{LAYERS} reorders of a [32, {HEADS}, {shapes}, {HEAD_DIM}] K/V cache"
        else:
            work = " + ".join(f"{LAYERS} x [B={c[1]}, M={c[2]}, S={c[3]}, {c[4]} mask]"
                              for c in shapes)
        source, replaces = KERNELS[kernel]
        out.append({"name": f"{kernel}[{', '.join(paths)}]", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r, _ in parts), "ms": total["ms"],
                    "plain_ms": total["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": total["library_ms"], "work": work})
    if {r["source"] for r in out} != {src for src, _ in KERNELS.values()}:
        raise AssertionError("a kernel is missing from the summary")
    return {"kernels": out}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "cxrmate_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F

    from cxrmate_torch.models import api
    from cxrmate_torch.ops import _build
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    lib = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": os.path.relpath(lib, REPO)})

    kernels = kernel_phase(torch, F, fa, da, br)
    tokenizer = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
    try:
        ckpts = {v: write_checkpoint(torch, api, tokenizer, v) for v in ("multi", "longitudinal")}
        counts = {"multi": main_phase(torch, np, ckpts["multi"])[1],
                  "longitudinal": longitudinal_phase(torch, np, ckpts["longitudinal"]),
                  "single": single_phase(torch, np, ckpts["multi"])}
        parity_phase(torch, np, ckpts)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    emit(kernels_line(da, kernels, counts))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
