"""Served reports: batches of studies back to back (a closed loop, as a
test-set run or a reporting service drives the model) through
``CXRMate.generate_report``, beam search or greedy as the mix says.

Set-up makes the weights and a pool of ``pool_batches`` distinct batches
from the seed, loads the weights through the program's own loader, and warms
the cell's one shape with an untimed batch. The window then serves the pool
round and round and ends at the first batch boundary after ``seconds``.
With ``trace`` the window's calls are timed on the synchronised host clock
and one more batch runs under ``torch.profiler``. After the window every
number is read, the program's state is freed, and the plain reference
judges a sample of the served studies (``reference.judge``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.faults import FAULTS
from benchmark.reference import judge, prompt
from benchmark.reference.model import tokens_per_image
from benchmark.weights import make_state_dict
from benchmark.work import beam_reorder as reorder_work
from benchmark.work import decode_attention as attention_work
from benchmark.work import model as model_work

Q8 = "cross-rowgroup-q8"
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def load_tokenizer(cfg: dict):
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    return ByteLevelBPETokenizer.from_file(os.path.join(CONFIGS, cfg["tokenizer"]))


def program_config(cfg: dict, sd: dict):
    """The program's configuration of the file's sizes, as
    ``CXRMate.from_hf_checkpoint`` settles it for a checkpoint."""
    from cxrmate_torch import configs as mc
    from cxrmate_torch.ckpt import hf

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    enc = pick(mc.CvtConfig, cfg["encoder"])
    dec = dataclasses.replace(pick(mc.BertDecoderConfig, cfg["decoder"]),
                              cross_attention_hidden_size=enc.projection_size,
                              tie_word_embeddings=hf.head_is_tied(sd))
    lora = None
    if cfg.get("lora"):
        rank = hf.lora_rank(sd)
        lora = mc.LoraConfig(r=rank, alpha=cfg["lora"]["alpha"] / cfg["lora"]["r"] * rank,
                             dropout=cfg["lora"]["dropout"])
    return mc.EncoderDecoderConfig(
        encoder=enc, decoder=dec, variant=cfg["variant"], lora=lora,
        image_size=cfg["image_size"], max_images_per_study=cfg["max_images_per_study"],
        decoder_max_len=cfg["decoder_max_len"], prompt_max_len=cfg["prompt_max_len"])


def load_program(cfg: dict, sd: dict, tok, device):
    """The program's model over the benchmark's state dict, through its own
    loader (``ckpt/hf.py:load_model_state``) and cast as
    ``CXRMate.from_hf_checkpoint`` casts after reading its file."""
    from cxrmate_torch.ckpt import hf
    from cxrmate_torch.models import api
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.utils.precision import cast_floats

    config = program_config(cfg, sd)
    model = ed.EncoderDecoder(config, device=device, dtype=torch.float32)
    hf.load_model_state(model, sd)
    model = cast_floats(model, getattr(torch, cfg["dtype"]))
    return api.CXRMate(config, model, tok, torch.device(device))


class Wrappers:
    """The benchmark's wrappers around the program's module-level functions
    that a served batch goes through. Always: decode steps counted and each
    batch's sequences kept; with ``judged`` (one batch at a time) the
    outputs the reference judges: the decoder's scores, the encoder rows
    and, for greedy rows, each step's logits of the judged studies. With
    ``timed``: encode calls timed on the synchronised host clock. With
    ``traced``: ``record_function`` ranges around each layer's calls, and
    the decode-attention and reorder work counted on the device."""

    def __init__(self, beams: int, max_new: int):
        from cxrmate_torch.models import api
        from cxrmate_torch.models import bert as bert_mod
        from cxrmate_torch.models import encoder_decoder as ed
        from cxrmate_torch.ops import beam_reorder as br
        from cxrmate_torch.ops import decode_attention as da

        self.beams, self.max_new = beams, max_new
        self.timed = self.traced = False
        self.batch: Optional[dict] = None
        self.seqs: List[torch.Tensor] = []  # every batch's, in order
        self.judged: Optional[dict] = None  # the batch being judged, while it is served
        self.kept: Optional[dict] = None  # the judged batch's outputs once served
        self.steps = 0
        self.encode_s = 0.0
        self.attn_calls: List[tuple] = []  # (unmasked keys on the device, work's other args)
        self.reorder_calls: List[tuple] = []
        self._masks: Dict[int, tuple] = {}
        self._undo = []
        decoder = "beam_search" if beams > 1 else "generate"
        self._wrap(api, decoder, self._decoder)
        self._wrap(ed, "encode_images", self._encode)
        self._wrap(bert_mod, "bert_step", self._step)
        self._wrap(bert_mod, "bert_prefill", self._ranged("prefill"))
        self._wrap(ed, "split_and_decode_sections", self._ranged("split_and_decode"))
        self._wrap(br, "beam_reorder_write", self._reorder)
        self._wrap(da, "decode_attention", self._attention)

    def _wrap(self, module, name, make):
        fn = getattr(module, name)
        wrapped = make(fn)
        if hasattr(fn, "launches"):  # a kernel wrapper counts its launches on its module name
            wrapped.launches = fn.launches
        setattr(module, name, wrapped)
        self._undo.append((module, name, fn))

    def restore(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)
        self._undo = []

    def _range(self, name):
        if self.traced:
            return torch.profiler.record_function(trace.RANGE + name)
        return contextlib.nullcontext()

    def _ranged(self, name):
        def make(fn):
            def wrapped(*a, **kw):
                with self._range(name):
                    return fn(*a, **kw)
            return wrapped
        return make

    def _decoder(self, fn):
        def wrapped(*a, **kw):
            with self._range("beam_search" if self.beams > 1 else "generate"):
                out = fn(*a, **kw)
            seqs, scores = out if self.beams > 1 else (out, None)
            self.seqs.append(seqs)
            if self.judged is not None:
                self.judged.update(seqs=seqs, scores=scores)
            return out
        return wrapped

    def _encode(self, fn):
        def wrapped(model, px, *a, **kw):
            if self.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with self._range("encode"):
                hidden, mask = fn(model, px, *a, **kw)
            if self.timed:
                torch.cuda.synchronize()
                self.encode_s += time.perf_counter() - t0
            if self.judged is not None:
                self.judged["hidden"] = hidden[self.batch["check_rows"]]  # a copy: a list
            return hidden, mask
        return wrapped

    def _step(self, fn):
        def wrapped(*a, **kw):
            self.steps += 1
            self._masks.clear()
            with self._range("decode_step"):
                logits, cache = fn(*a, **kw)
            if self.beams == 1 and self.judged is not None:  # greedy rows keep their places
                self._keep_logits(logits)
            return logits, cache
        return wrapped

    def _keep_logits(self, logits):
        """The judged rows' logits of this step, into one buffer (not a
        tensor a step: many small live tensors slow Python's collector, and
        with it the host-bound loop)."""
        kept, rows = self.judged, self.batch["check_rows_t"]
        if "logits" not in kept:
            kept["logits"] = logits.new_empty((rows.numel(), self.max_new, logits.shape[-1]))
            kept["n"] = 0
        kept["logits"][:, kept["n"]] = logits.index_select(0, rows)
        kept["n"] += 1

    def _held(self, t, count):
        """A count over ``t`` on the device, once a step for each tensor
        (self and cross masks, the beam selection), no host sync."""
        held = self._masks.get(id(t))
        if held is None:
            held = self._masks[id(t)] = (t, count(t))
        return held[1]

    def _attention(self, fn):
        def wrapped(q, k, v, mask, scale, *a, **kw):
            if self.traced:
                keys = self._held(mask, lambda m: (m == 0).sum())
                self.attn_calls.append((keys, tuple(q.shape), q.element_size(), mask.numel()))
            return fn(q, k, v, mask, scale, *a, **kw)
        return wrapped

    def _reorder(self, fn):
        def wrapped(cache_k, cache_v, new_k, new_v, sel, index, beams, *a, **kw):
            if self.traced:
                local = lambda s: (s.long() != torch.arange(s.numel(), device=s.device) % beams).sum()
                moved = self._held(sel, local)
                self.reorder_calls.append((moved, tuple(cache_k.shape), cache_k.element_size(),
                                           index >= 0))
            with self._range("reorder"):
                return fn(cache_k, cache_v, new_k, new_v, sel, index, beams, *a, **kw)
        return wrapped

    def work(self) -> dict:
        """Bytes and operations of the traced calls (``benchmark/work``)."""
        out = {"attention_bytes": 0.0, "attention_flops": 0.0, "reorder_bytes": 0.0}
        if self.attn_calls:
            keys = torch.stack([c[0] for c in self.attn_calls]).tolist()
            for n, (_, shape, item, mask_numel) in zip(keys, self.attn_calls):
                nbytes, flops = attention_work.work(shape, item, mask_numel, n)
                out["attention_bytes"] += nbytes
                out["attention_flops"] += flops
        if self.reorder_calls:
            moved = torch.stack([c[0] for c in self.reorder_calls]).tolist()
            for n, (_, shape, item, writes) in zip(moved, self.reorder_calls):
                out["reorder_bytes"] += reorder_work.work(shape, item, n, writes)
        self.attn_calls, self.reorder_calls = [], []
        return out


class Cell:
    """A served cell: set up, run a window, trace a batch, judge a sample."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device="cuda", decode_kernel: str = ""):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.beams = mix["num_beams"]
        self.decode_kernel = decode_kernel
        self.tok = load_tokenizer(cfg)
        self.ids = prompt.special_ids(cfg)
        self.sd = make_state_dict(cfg, seed, device, getattr(torch, cfg["dtype"]))
        self.pool = [inputs.make_batch(mix, cfg, self.tok, seed, i, device)
                     for i in range(mix["pool_batches"])]
        self.model = load_program(cfg, self.sd, self.tok, device)
        self.wrappers = Wrappers(self.beams, mix["max_new_tokens"])
        self.next = 0
        self.batches: List[dict] = []  # the window's: pool index, seconds, steps
        self.draws = np.random.default_rng([seed, 7])

    def close(self):
        self.wrappers.restore()

    def serve(self, batch: dict, judge: bool = False) -> dict:
        """One batch through ``generate_report``; returns its record.
        ``judge``: keep its outputs as the judged batch."""
        w = self.wrappers
        w.batch = batch
        w.judged = {} if judge else None
        steps0, enc0 = w.steps, w.encode_s
        kw = dict(num_beams=self.beams, max_new_tokens=self.mix["max_new_tokens"],
                  decode_kernel=self.decode_kernel)
        if batch["prompts"] is not None:
            kw.update(previous_findings=batch["prompts"][0], previous_impression=batch["prompts"][1])
        t0 = time.perf_counter()
        with w._range("generate_report"):
            findings, impression = self.model.generate_report(batch["pixels"], **kw)
        secs = time.perf_counter() - t0
        if judge:
            w.kept, w.judged = w.judged, None
        ok = sum(isinstance(f, str) and isinstance(i, str) for f, i in zip(findings, impression))
        return {"seconds": secs, "steps": w.steps - steps0, "encode_s": w.encode_s - enc0,
                "studies": len(findings), "failed": len(findings) - ok}

    def warm(self):
        """One untimed batch at the cell's shape (every pool batch has it)."""
        self.serve(self.pool[0])
        sync(self.device)
        self.wrappers.seqs.clear()

    def window(self, seconds: float, timed: bool = False) -> dict:
        """Batches back to back until ``seconds`` have passed. The judged
        batch is drawn from the seed among all the window's batches, one
        kept at a time (a reservoir: batch i replaces it with chance 1/i)."""
        w = self.wrappers
        w.timed = timed
        start = time.perf_counter()
        while True:
            index = self.next % len(self.pool)
            self.next += 1
            judge = self.draws.random() * (len(self.batches) + 1) < 1.0
            rec = self.serve(self.pool[index], judge)
            rec["pool_index"] = index
            if judge:
                self.judged_batch = len(self.batches)
            self.batches.append(rec)
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        w.timed = False
        return {"window_s": window_s, "batches": len(self.batches),
                "studies": sum(b["studies"] for b in self.batches),
                "failed": sum(b["failed"] for b in self.batches),
                "steps": sum(b["steps"] for b in self.batches),
                "encode_s": sum(b["encode_s"] for b in self.batches),
                "batch_s": sum(b["seconds"] for b in self.batches),
                "per_batch": [[b["steps"], b["seconds"]] for b in self.batches]}

    def traced_batch(self) -> dict:
        """One more batch traced on the device alone (its busy time, its
        length, the kernels' times), then the same batch again with the
        host's ranges traced too, which only names the first one's idle
        gaps and counts the kernels' work (the same inputs give the same
        decode). ``slowdown``: each traced batch's length over the window's
        untraced batches of the same inputs."""
        w = self.wrappers
        index = self.next % len(self.pool)
        summary: dict = {}
        with trace.traced(summary):
            self.serve(self.pool[index])
        w.seqs.pop()
        named: dict = {}
        w.traced = True
        try:
            with trace.traced(named, host=True):
                self.serve(self.pool[index])
        finally:
            w.traced = False
            w.seqs.pop()
        summary["work"] = w.work()
        idle = summary["window_s"] - summary["busy_s"]
        summary["breakdown"] = {"device_ops": summary.pop("device_ops"),
                                "idle_gaps": trace.named_gaps(named["gaps"], idle)[:trace.TOP]}
        same = [b["seconds"] for b in self.batches if b["pool_index"] == index]
        untraced = float(np.mean(same or [b["seconds"] for b in self.batches]))
        summary["slowdown"] = {"device_traced": summary["window_s"] / untraced,
                               "host_traced": named["window_s"] / untraced}
        return summary

    # ------------------------------------------------------------- readings
    def real_prompt_lengths(self, seqs: torch.Tensor) -> List[int]:
        p_len = seqs.shape[1] - self.mix["max_new_tokens"]
        if self.cfg["variant"] != "longitudinal":
            return [1] * seqs.shape[0]
        return (seqs[:, :p_len] != self.ids["pad"]).sum(dim=1).tolist()

    def window_flops(self) -> float:
        t_img = tokens_per_image(self.cfg["encoder"], self.cfg["image_size"])
        total = 0.0
        for rec, seqs in zip(self.batches, self.wrappers.seqs):
            batch = self.pool[rec["pool_index"]]
            total += model_work.served_batch(self.cfg, t_img, batch["counts"],
                                             self.real_prompt_lengths(seqs), self.beams,
                                             rec["steps"])
        return total

    def free_program(self):
        self.wrappers.restore()
        self.model = None
        sync(self.device)
        if str(self.device).startswith("cuda"):
            torch.cuda.empty_cache()

    def sample(self) -> dict:
        """What the reference judges: the judged batch's prompt columns, as
        served, and its check rows' served tokens and outputs (the longest
        request among them), with the batch's inputs."""
        kept = self.wrappers.kept
        batch = self.pool[self.batches[self.judged_batch]["pool_index"]]
        rows = batch["check_rows"]
        seqs = kept["seqs"].long()
        p_len = seqs.shape[1] - self.mix["max_new_tokens"]
        logits = kept["logits"][:, :kept["n"]] if "logits" in kept else None
        return {"pixels": batch["pixels"][rows], "prompts": batch["prompts"], "rows": rows,
                "served_prompt": seqs[:, :p_len].cpu(), "new": seqs[rows, p_len:],
                "hidden": kept["hidden"],
                "scores": None if kept["scores"] is None else kept["scores"][rows],
                "logits": logits}

    def reference(self, s: dict, precision: str = "fp32") -> dict:
        """The reference's prompt of the whole judged batch, made again from
        the studies' previous reports, and its outputs behind the check
        rows' served tokens that follow that prompt."""
        ids, first_col = prompt.prompt_ids(self.cfg, s["prompts"], s["served_prompt"].shape[0])
        seqs = torch.cat([ids[s["rows"]].to(s["new"].device), s["new"]], dim=1)
        sd = {k: v.float() for k, v in self.sd.items()}
        out = judge.reference_outputs(sd, self.cfg, self.ids, s["pixels"], seqs, ids.shape[1],
                                      first_col, precision)
        out["prompt"] = ids
        return out

    def numbers(self, s: dict, ref: dict) -> dict:
        got = judge.numbers(ref, s["new"], self.ids["eos"], self.beams, s["hidden"], s["scores"],
                            s["logits"])
        got["prompt_err"] = judge.prompt_err(ref["prompt"], s["served_prompt"])
        return got


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float, trace_on: bool,
        device="cuda", t_start: Optional[float] = None) -> dict:
    """One run of a served cell -> the readings for the metric readers, the
    compared numbers with their limits, and the device figures."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cfg, mix, seed, device)
    try:
        cell.warm()
        # set-up's objects out of the collector's way, as a long-running server
        # process does once its model is loaded
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        gc0 = [g["collections"] for g in gc.get_stats()]
        win = cell.window(seconds, timed=trace_on)
        win["gc_collections"] = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
        peak = torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0
        out = {"kind": "serve", "setup_s": setup_s, **win, "memory_peak_bytes": peak, "beams": cell.beams,
               "dtype": cfg["dtype"], "slots": cfg["max_images_per_study"]}
        if trace_on:
            out["trace"] = cell.traced_batch()
            out["flops"] = cell.window_flops()
        s = cell.sample()
        cell.free_program()
        ref = cell.reference(s)
        got = cell.numbers(s, ref)
        out["check"] = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
        return out
    finally:
        cell.close()
        gc.unfreeze()


def again(cell, fault=None) -> dict:
    """The window's first batch served again, judged as a run judges it;
    ``fault`` planted beneath the harness's wrappers, as under a run."""
    cell.wrappers.restore()
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        cell.wrappers = Wrappers(cell.beams, cell.mix["max_new_tokens"])
        try:
            cell.next, cell.batches, cell.wrappers.seqs = 0, [], []
            cell.window(0)
            s = cell.sample()
        finally:
            cell.wrappers.restore()
    cell.wrappers = Wrappers(cell.beams, cell.mix["max_new_tokens"])
    return cell.numbers(s, cell.reference(s))


def readings(cfg: dict, mix: dict, seed: int, device: str = "cuda", q8: bool = True,
             faults=()) -> dict:
    """The control's readings (``control.py``) at the cell's sizes: one
    batch served as the window serves it, judged for the program; the
    reference in float8 in the program's place on the same prompts and
    tokens; each fault of ``benchmark/faults.py`` and the program's int8
    cross cache (``decode_kernel="cross-rowgroup-q8"``), the same batch
    served again and judged alike."""
    cell = Cell(cfg, mix, seed, device)
    try:
        cell.window(0)
        s = cell.sample()
        ref = cell.reference(s)
        out = {"seed": seed, "program": cell.numbers(s, ref)}
        low = cell.reference(s, "fp8")
        out["fp8"] = judge.control_numbers(ref, low, s["new"], cell.ids["eos"], cell.beams)
        for fault in faults:
            out[fault] = again(cell, fault)
        if q8:
            cell.decode_kernel = Q8
            out["q8"] = again(cell)
        return out
    finally:
        cell.close()
        del cell
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
