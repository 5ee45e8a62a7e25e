#!/usr/bin/env python3
"""Drive the PyTorch port (cxrmate_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each printing one JSON line:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - builds the CUDA kernels from cxrmate_torch/csrc (nvcc, sm_90a).
  3. kernels - each kernel against its plain PyTorch version on the card at
               the main path's full-width shapes, fp32 (TF32 off, <= 1e-5) and
               bf16 (<= 1e-2; decode attention must also match the plain
               version bit for bit more often than a version that skips
               rounding the probs), the reorder bit-exact; times of the kernel, the
               plain version, one PyTorch library call computing the same
               function (timed only, never used by the port) and the least
               time the card could take (bound).
  4. main    - a seeded random full-width multi model (CvT-21@384, BERT
               6x768, the repository tokenizer's vocabulary) written as an HF
               directory, loaded with CXRMate.from_hf_checkpoint and run
               through generate_report on 8 studies x 5 image slots (some
               all-zero) in bf16, greedy and beam-4: one untimed call, then
               three timed calls per mode; studies/s and new tokens/s of the
               median call beside every call's; each call's launch counts
               checked against the counts the path implies.
  5. parity  - the whole path with the kernels against the same path with
               every kernel swapped for its plain version: encoder states,
               greedy decoder logits over a prefill and 16 teacher-fed steps,
               and beam-4 logits over 16 teacher-fed steps with the deferred
               write and the reorder; fp32 (TF32 off) held to 1e-3, bf16 to
               0.25; the greedy token agreement is printed.
Then the card's name and power limit, the kernels summary line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and the last line is not printed.
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
def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash(torch, fa, F, dtype):
    """The three CvT-21@384 stage shapes of one encode of STUDIES x SLOTS
    images: (BH, Lq, Lk, calls per encode)."""
    n_img = STUDIES * SLOTS
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


def decode_work(q, mask):
    """Bytes and operations decode attention needs on these inputs: q, the
    output, the mask, and K and V of the unmasked keys only (a key under
    finfo(f32).min gets probability exactly 0 and cannot change the output)."""
    b, h, m, dh = q.shape
    keys = float((mask == 0).sum())  # unmasked (row, key) pairs
    e = q.element_size()
    return 2 * q.numel() * e + 2 * keys * h * dh * e + mask.numel() * 4, 4.0 * keys * h * m * dh


def _mismatch(a, b) -> float:
    """Share of elements that are not bit-equal."""
    return float((a != b).float().mean())


def _unrounded(q, k, v, mask, scale):
    """Decode attention with the probs kept in fp32 before P.V: what a kernel
    that skipped the contract's rounding would compute."""
    p = ((q.float() @ k.float().transpose(-1, -2)) * scale + mask[:, None, None, :]).softmax(-1)
    return (p @ v.float()).to(q.dtype)


def check_decode(torch, da, F, dtype, copies):
    """Per decode step of STUDIES studies: 6 self-attention calls over the
    256-column self cache (half of it unmasked) and 6 cross-attention calls
    over 5 x 576 encoder keys with the all-zero slots masked; greedy (M = 1)
    and beam-4 (beams folded into M = 4 over the per-study cross cache). In
    bf16 the kernel must also agree bit for bit with the plain version more
    often than with a version that skips rounding the probs."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt = "bf16" if dtype == torch.bfloat16 else "fp32"
    h, dh, t_len, s_len = 12, 64, 256, SLOTS * 576
    neg = torch.finfo(torch.float32).min
    cross_mask = torch.zeros(STUDIES, s_len, device="cuda")
    for i, n in enumerate(IMAGES_PER_STUDY):
        cross_mask[i, n * 576:] = neg
    modes = {
        "greedy": [(STUDIES, 1, t_len, None), (STUDIES, 1, s_len, cross_mask)],
        "beam4": [(STUDIES * 4, 1, t_len, None), (STUDIES, 4, s_len, cross_mask)],
    }
    res = {}
    for mode, calls in modes.items():
        out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "max_abs_err": 0.0, "per_shape": []}
        for b, m, s, mask in calls:
            if mask is None:  # self-attention: columns past the step are masked
                mask = torch.zeros(b, s, device="cuda")
                mask[:, 128:] = neg
            sets = []
            for _ in range(copies):
                q = torch.randn(b, h, m, dh, generator=g, device="cuda").to(dtype)
                k = torch.randn(b, h, s, dh, generator=g, device="cuda").to(dtype)
                v = torch.randn(b, h, s, dh, generator=g, device="cuda").to(dtype)
                sets.append((q, k, v))
            q, k, v = sets[0]
            got = da.decode_attention(q, k, v, mask, 0.125)
            want = da.decode_attention_plain(q, k, v, mask, 0.125)
            err = _err(got, want)
            shape = {"b": b, "m": m, "s": s, "calls": 6, "max_abs_err": err}
            if dtype == torch.bfloat16:
                shape["mismatch_share"] = _mismatch(got, want)
                shape["mismatch_share_unrounded"] = _mismatch(
                    got, _unrounded(q, k, v, mask, 0.125))
                if not shape["mismatch_share"] < shape["mismatch_share_unrounded"]:
                    raise AssertionError(f"decode_attention bf16 {shape}: the probs do not "
                                         "look rounded to bf16 before P.V")
            ms = time_ms([lambda a=a: da.decode_attention(*a, mask, 0.125) for a in sets])
            plain = time_ms([lambda a=a: da.decode_attention_plain(*a, mask, 0.125) for a in sets])
            bool_mask = (mask == 0)[:, None, None, :]
            lib = time_ms([lambda a=a: F.scaled_dot_product_attention(
                *a, attn_mask=bool_mask, scale=0.125) for a in sets])
            nbytes, flops = decode_work(q, mask)
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bytes", nbytes), ("flops", flops)):
                out[key] += 6 * val
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["per_shape"].append({**shape, "ms": ms, "plain_ms": plain, "library_ms": lib,
                                     "bound_ms": bound_ms(nbytes, flops, dt)[0]})
        res[mode] = out
    return res


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


def check_reorder(torch, br, dtype, copies):
    """Per beam step: 6 in-place reorders of the [32, 12, 256, 64] self K/V
    cache of STUDIES studies x 4 beams, with the step's column written."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    r, h, t_len, dh, beams = STUDIES * 4, 12, 256, 64, 4

    def inputs():
        ck = torch.randn(r, h, t_len, dh, generator=g, device="cuda").to(dtype)
        cv = torch.randn(r, h, t_len, dh, generator=g, device="cuda").to(dtype)
        nk = torch.randn(r, h, dh, generator=g, device="cuda").to(dtype)
        nv = torch.randn(r, h, dh, generator=g, device="cuda").to(dtype)
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
    sets = [inputs() for _ in range(copies)]
    src = torch.arange(r, device="cuda") // beams * beams + sel.long()
    col = torch.tensor([100], device="cuda")

    def library(ck, cv, nk, nv):  # index_select + index_copy_
        for cache, new in ((ck, nk), (cv, nv)):
            out = cache.index_select(0, src)
            out.index_copy_(2, col, new.index_select(0, src)[:, :, None])

    ms = time_ms([lambda a=a: br.beam_reorder_write(*a, sel, 100, beams) for a in sets])
    plain = time_ms([lambda a=a: br.beam_reorder_write_plain(*a, sel, 100, beams) for a in sets])
    lib = time_ms([lambda a=a: library(*a) for a in sets])
    nbytes = reorder_work(sets[0][0], sel, 100, beams)
    return {"ms": 6 * ms, "plain_ms": 6 * plain, "library_ms": 6 * lib, "bytes": 6 * nbytes,
            "flops": 0.0, "max_abs_err": 0.0 if exact else float("inf"), "exact": exact,
            "per_call_ms": ms}


def kernel_phase(torch, F, fa, da, br):
    """Each kernel against its plain version, fp32 (TF32 off) then bf16."""
    from cxrmate_torch.utils.precision import parity_mode

    results = {}
    for name, dtype, tol in (("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 1e-2)):
        with parity_mode():
            flash = check_flash(torch, fa, F, dtype)
            decode = check_decode(torch, da, F, dtype, copies=4)
            reorder = check_reorder(torch, br, dtype, copies=4)
        for kname, r in (("flash_attention", flash), ("decode_attention[greedy]", decode["greedy"]),
                         ("decode_attention[beam4]", decode["beam4"]),
                         ("beam_reorder_write", reorder)):
            bound, bound_by = bound_ms(r["bytes"], r["flops"], name)
            emit({"phase": "kernels", "dtype": name, "kernel": kname, "tolerance": tol,
                  "bound_ms": bound, "bound_by": bound_by,
                  **{k: v for k, v in r.items() if k not in ("bytes", "flops")}})
            if not r["max_abs_err"] <= tol:
                raise AssertionError(f"{kname} {name}: max abs err {r['max_abs_err']} > {tol}")
        if not reorder["exact"]:
            raise AssertionError(f"beam_reorder_write {name}: not bit-exact")
        results[name] = {"flash": flash, "decode": decode, "reorder": reorder}
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

    saved = (fa.flash_attention, da.decode_attention, br.beam_reorder_write)
    fa.flash_attention = fa.flash_attention_plain
    da.decode_attention = da.decode_attention_plain
    br.beam_reorder_write = br.beam_reorder_write_plain
    try:
        yield
    finally:
        fa.flash_attention, da.decode_attention, br.beam_reorder_write = saved


def make_pixels(np):
    rs = np.random.RandomState(SEED)
    px = rs.randn(STUDIES, SLOTS, 3, 384, 384).astype(np.float32)
    for i, n in enumerate(IMAGES_PER_STUDY):
        px[i, n:] = 0.0
    return px


def write_checkpoint(torch, api, tokenizer_path):
    """A seeded random full-width multi model as an HF directory."""
    from cxrmate_torch.ckpt.hf import save_hf_pretrained_dir
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer.from_file(tokenizer_path)
    model = api.CXRMate.random_init(tok, variant="multi", dtype=torch.float32, seed=SEED,
                                    device="cuda")
    path = os.path.join(SMOKE_DIR, "cxrmate-multi-random")
    save_hf_pretrained_dir(path, model.model.state_dict(), model.config)
    shutil.copy(tokenizer_path, os.path.join(path, "tokenizer.json"))
    return path


def new_tokens(seqs, eos) -> int:
    """Tokens generated, each row counted up to and including its EOS."""
    total = 0
    for row in seqs[:, 1:]:
        hits = (row == eos).nonzero()[0]
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def drive(model, px, mode, beams, depth, layers):
    """One generate_report call, the main path, with every launch count set
    to 0 just before it and read just after; checks the counts and the
    output and returns the call's figures."""
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    import torch

    tok = model.tokenizer
    rec = Recorder()
    rec.wrap(bert_mod, "bert_step")
    rec.wrap(ed, "encode_images", timed=True)
    rec.wrap(api, "beam_search" if beams > 1 else "generate", keep=True)
    fa.flash_attention.launches = da.decode_attention.launches = 0
    br.beam_reorder_write.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        findings, impression = model.generate_report(px, num_beams=beams)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "decode_attention": da.decode_attention.launches,
                "beam_reorder_write": br.beam_reorder_write.launches}
    steps = rec.calls.get("bert_step", 0)
    want = {"flash_attention": depth, "decode_attention": 2 * layers * steps,
            "beam_reorder_write": layers * (steps + 1) if beams > 1 else 0}
    if launches != want or steps == 0:
        raise AssertionError(f"{mode}: launches {launches}, expected {want} ({steps} steps)")
    out = rec.outputs["beam_search" if beams > 1 else "generate"]
    seqs = (out[0] if beams > 1 else out).cpu().numpy()
    if not (len(findings) == len(impression) == STUDIES
            and all(isinstance(s, str) for s in findings + impression)):
        raise AssertionError(f"{mode}: malformed reports")
    if seqs.shape != (STUDIES, model.config.decoder_max_len) or \
            not ((seqs >= 0) & (seqs < len(tok))).all():
        raise AssertionError(f"{mode}: sequences {seqs.shape} out of range")
    ntok = new_tokens(seqs, tok.eos_token_id)
    enc_s = rec.seconds["encode_images"]
    return {"seconds": secs, "studies_per_s": STUDIES / secs, "new_tokens_per_s": ntok / secs,
            "new_tokens": ntok, "encode_s": enc_s, "decode_s": secs - enc_s,
            "decode_ms_per_step": (secs - enc_s) / steps * 1e3, "decode_steps": steps,
            "launches": launches, "first_findings": findings[0][:80]}


def main_phase(torch, np, ckpt):
    """Each mode: one untimed call at the timed shapes (full length: cuBLAS
    handles, allocator growth), then MAIN_RUNS timed calls; the median call's
    figures are reported beside every call's studies/s."""
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
        emit({"phase": "main", "mode": mode, "dtype": "bf16", "studies": STUDIES,
              "image_slots": SLOTS, "runs": MAIN_RUNS, "reported": "median", **results[mode]})
    return results, counts


def parity_phase(torch, np, ckpt):
    """The kernel path against the plain path on the card, on the same token
    sequences: the encoder states, greedy decoding (prefill and teacher-fed
    bert_step with the cache written) and beam-4 decoding (bert_step with the
    write deferred, then the reorder with seeded beam choices). fp32 with TF32
    off is held to PARITY_TOL, bf16 (the serving dtype) to BF16_PARITY_TOL;
    both must be finite."""
    from cxrmate_torch.generate.decode import GenerationConfig, generate, prefill
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.utils.precision import parity_mode

    n, beams, steps = 2, 4, 16
    pixels = torch.from_numpy(make_pixels(np)[:n]).cuda()
    t_total = 1 + steps
    results = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        with parity_mode(), torch.no_grad():
            model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=dtype,
                                                   device="cuda")
            tok = model.tokenizer
            g = torch.Generator().manual_seed(SEED + 3)  # the same tokens and choices each dtype
            beam_feed = torch.randint(0, len(tok), (n * beams, t_total), generator=g).int().cuda()
            beam_sel = torch.randint(0, beams, (t_total, n * beams), generator=g).int().cuda()
            gen_cfg = GenerationConfig(max_new_tokens=steps, eos_token_id=tok.eos_token_id,
                                       pad_token_id=tok.pad_token_id,
                                       bos_token_id=tok.bos_token_id,
                                       special_token_ids=(tok.sep_token_id,))
            prompt = torch.full((n, 1), tok.bos_token_id, dtype=torch.int32, device="cuda")
            cols = torch.arange(t_total, device="cuda")
            px = pixels.to(dtype)

            def run(tokens=None):
                hidden, mask = ed.encode_images(model.model, px)
                logits0, cache = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
                seq = generate(model.model, gen_cfg, hidden, mask, prompt, None)
                feed = seq if tokens is None else tokens
                greedy = [logits0[:, 0]]
                for i in range(1, t_total - 1):
                    pos = torch.full((n,), i, dtype=torch.long, device="cuda")
                    ttype = torch.zeros(n, dtype=torch.int32, device="cuda")
                    key_mask = (cols <= i).int().expand(n, t_total).contiguous()
                    logits, cache = bert_mod.bert_step(model.model.decoder, cache, feed[:, i],
                                                       ttype, pos, i, key_mask, mask)
                    greedy.append(logits)
                _, cache = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
                cache.self_k = [x.repeat_interleave(beams, 0) for x in cache.self_k]
                cache.self_v = [x.repeat_interleave(beams, 0) for x in cache.self_v]
                beam = []
                for i in range(1, t_total - 1):
                    pos = torch.full((n * beams,), i, dtype=torch.long, device="cuda")
                    ttype = torch.zeros(n * beams, dtype=torch.int32, device="cuda")
                    key_mask = (cols <= i).int().expand(n * beams, t_total).contiguous()
                    logits, (nk, nv) = bert_mod.bert_step(
                        model.model.decoder, cache, beam_feed[:, i], ttype, pos, i, key_mask,
                        mask, deferred_write=True)
                    for li in range(len(cache.self_k)):
                        br.beam_reorder_write(cache.self_k[li], cache.self_v[li], nk[li], nv[li],
                                              beam_sel[i], i, beams)
                    beam.append(logits)
                return hidden, torch.stack(greedy, 1), torch.stack(beam, 1), seq

            h_k, g_k, b_k, seq_k = run()
            with plain_kernels():
                h_p, g_p, b_p, seq_p = run(tokens=seq_k)
            torch.cuda.synchronize()
        res = {"encoder_max_abs_err": _err(h_k, h_p), "greedy_logits_max_abs_err": _err(g_k, g_p),
               "beam4_logits_max_abs_err": _err(b_k, b_p), "steps": g_k.shape[1],
               "greedy_token_agreement": float((seq_k == seq_p).float().mean()),
               "finite": bool(all(torch.isfinite(x.float()).all() for x in (h_k, g_k, b_k)))}
        res["tolerance"] = PARITY_TOL if name == "fp32" else BF16_PARITY_TOL
        emit({"phase": "parity", "dtype": name, **res})
        errs = [v for k, v in res.items() if k.endswith("max_abs_err")]
        if not (res["finite"] and max(errs) <= res["tolerance"]):
            raise AssertionError(f"{name}: kernel path disagrees with the plain path: {res}")
        results[name] = res
        del model
    return results


def kernels_line(k, counts):
    """The summary: bf16 (the serving dtype) times per unit of main-path work."""
    bf = k["bf16"]
    rows = [
        ("flash_attention", "cxrmate_torch/csrc/flash_attention.cu",
         "cxrmate_tpu/ops/flash_attention.py:60", bf["flash"],
         counts["greedy"]["flash_attention"] + counts["beam4"]["flash_attention"]),
        ("decode_attention[greedy step]", "cxrmate_torch/csrc/decode_attention.cu",
         "cxrmate_tpu/ops/decode_attention.py:50", bf["decode"]["greedy"],
         counts["greedy"]["decode_attention"]),
        ("decode_attention[beam-4 step]", "cxrmate_torch/csrc/decode_attention.cu",
         "cxrmate_tpu/ops/decode_attention.py:50", bf["decode"]["beam4"],
         counts["beam4"]["decode_attention"]),
        ("beam_reorder_write[beam-4 step]", "cxrmate_torch/csrc/beam_reorder.cu",
         "cxrmate_tpu/ops/beam_reorder.py:58", bf["reorder"],
         counts["beam4"]["beam_reorder_write"]),
    ]
    out = []
    for name, src, rep, r, launches in rows:
        b, by = bound_ms(r["bytes"], r["flops"], "bf16")
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
                    "library_ms": r["library_ms"]})
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
    ckpt = write_checkpoint(torch, api, os.path.join(REPO, "artifacts", "tokenizer",
                                                     "bpe_prompt", "tokenizer.json"))
    try:
        main_res, counts = main_phase(torch, np, ckpt)
        parity_phase(torch, np, ckpt)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    emit(kernels_line(kernels, counts))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
