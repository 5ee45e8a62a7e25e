"""The program's spans and counters (``cxrmate_torch.utils.tracing``) in the
report path: nothing recorded outside a profiler, the span tree of greedy
and beam decodes, the spans on the profiler's clock, the idle gaps named by
span, and tokens unchanged by recording. The card test holds the program's
``host_read`` count to torch's own count of synchronising calls. No JAX
here: the card test runs with ``--noconftest``."""

import os
import warnings
from collections import Counter, defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from cxrmate_torch import configs as mc
from cxrmate_torch.generate.beam import beam_search
from cxrmate_torch.generate.decode import generate
from cxrmate_torch.models.api import CXRMate
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
NEW = 6  # new tokens a call: 5 decode steps unless every row ends sooner
PREVIOUS = (["Heart size is normal.", None, "Lungs are clear. No effusion."],
            ["No acute process.", None, "Stable."])
# Both stamps of a span and of its range come from the one epoch clock; the
# span is stamped inside its range, so a span lying outside its range by more
# than the profiler's conversion of its own clock to the epoch (microseconds)
# is a fault.
CLOCK_NS = 20_000


def tiny_config(variant: str, vocab: int) -> mc.EncoderDecoderConfig:
    return mc.EncoderDecoderConfig(
        encoder=mc.CvtConfig(embed_dim=(8, 12, 16), num_heads=(1, 2, 2), depth=(1, 1, 1),
                             drop_path_rate=(0.0, 0.0, 0.0), projection_size=16),
        decoder=mc.BertDecoderConfig(vocab_size=vocab, hidden_size=16, num_hidden_layers=2,
                                     num_attention_heads=2, intermediate_size=32,
                                     max_position_embeddings=64, cross_attention_hidden_size=16),
        variant=variant, lora=mc.LoraConfig() if variant == "longitudinal" else None,
        image_size=32, decoder_max_len=24, prompt_max_len=32, max_images_per_study=2)


@pytest.fixture(scope="module")
def models():
    tok = ByteLevelBPETokenizer.from_file(TOKENIZER)
    return {v: CXRMate.random_init(tok, config=tiny_config(v, len(tok)), device="cpu", seed=3)
            for v in ("multi", "longitudinal")}


def pixels(device="cpu", dtype=torch.float32, studies=3, slots=2, size=32):
    g = torch.Generator().manual_seed(7)
    px = torch.rand(studies, slots, 3, size, size, generator=g)
    px[0, 1:] = 0  # a study with one image
    return px.to(device, dtype)


# (variant, beams): greedy without a prompt, beam-2 with one
CASES = [("multi", 1), ("longitudinal", 2)]


def report(model, beams, px=None, **kw):
    prompts = PREVIOUS if model.config.variant == "longitudinal" else (None, None)
    return model.generate_report(pixels() if px is None else px, *prompts, num_beams=beams,
                                 max_new_tokens=NEW, **kw)


def recorded(fn):
    """``fn()`` under a CPU profiler -> (its result, the new request, the session)."""
    before = len(tracing.requests())
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    reqs = tracing.requests()
    assert len(reqs) == min(before + 1, tracing.KEEP), "one request a call"
    return out, reqs[-1], prof


def children(spans):
    kids = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    return kids


def test_nothing_recorded_outside_a_profiler(models):
    before = tracing.requests()
    for variant, beams in CASES:
        report(models[variant], beams)
    assert tracing.requests() == before and all(
        a is b for a, b in zip(tracing.requests(), before))
    assert tracing.span("encode") is tracing.span("decode_step")  # the shared no-op
    tracing.count("host_read")  # no open span, no session: nothing to add to


@pytest.mark.parametrize("variant,beams", CASES)
def test_span_tree(models, variant, beams):
    _, spans, _ = recorded(lambda: report(models[variant], beams))
    root = spans[0]
    assert (root.name, root.parent) == ("generate_report", None)
    assert {s.request for s in spans} == {root.request}
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        p = by_id[s.parent]
        assert p.t0 <= s.t0 <= s.t1 <= p.t1, (p, s)
    kids = children(spans)
    top = [s.name for s in kids[root.id]]
    steps = [s for s in kids[root.id] if s.name == "decode_step"]
    assert 1 <= len(steps) <= NEW - 1
    want = ["encode"] + (["prompt"] if variant == "longitudinal" else []) + ["prefill"]
    want += ["select"] + (["reorder"] if beams > 1 else []) + ["stop_check"]
    want += ["decode_step"] * len(steps) + ["split_and_decode"]
    assert top == want
    step_kids = ["bert_step", "select"] + (["reorder"] if beams > 1 else []) + ["stop_check"]
    for step in steps:
        assert [s.name for s in kids[step.id]] == step_kids
        assert step.counts == {"decode_steps": 1}
        check = kids[step.id][-1]
        assert check.counts == {"host_read": 1}
        bert = kids[step.id][0]
        assert [s.name for s in kids[bert.id]] == ["embed", "layer", "layer", "lm_head"]
    total = Counter()
    for s in spans:
        total.update(s.counts)
    # the first stop check; split_and_decode's copy; the prompt's two copies and
    # the token types' constants (one a special) in the prefill; the specials
    specials = 3 if variant == "longitudinal" else 1
    setup = 1 + 1 + (2 if variant == "longitudinal" else 0) + specials + 1
    assert total["host_read"] == len(steps) + setup
    assert total["decode_steps"] == len(steps)
    assert total["images"] == 3 * 2 and kids[root.id][0].counts == {"images": 6}
    assert all(s.device_ms is None for s in spans)  # CUDA events only on the card


def test_spans_lie_within_their_profiler_ranges(models):
    _, spans, prof = recorded(lambda: report(models["longitudinal"], 2))
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(tracing.PREFIX)), key=lambda e: e.start_ns())
    assert [e.name() for e in ranges] == [tracing.PREFIX + s.name for s in spans]
    for e, s in zip(ranges, spans):
        assert e.start_ns() - CLOCK_NS <= s.t0 and s.t1 <= e.start_ns() + e.duration_ns() + CLOCK_NS


def test_idle_by_span_names_each_gap_by_its_innermost_span():
    S = tracing.Span
    spans = [S(1, 1, None, "generate_report", 0, 1000), S(1, 2, 1, "decode_step", 100, 500),
             S(1, 3, 2, "stop_check", 400, 500), S(1, 4, 1, "decode_step", 500, 900)]
    # device busy [0,50) [60,120) [130,410) [490,700) [690,750) [950,990) [1100,1200)
    device = [(130, 410), (0, 50), (60, 120), (490, 700), (690, 750), (950, 990), (1100, 1200)]
    got = tracing.idle_by_span(device, spans)
    # gaps: 50-60 (root), 120-130 (step 2), 410-490 (stop_check, mid 450),
    # 750-950 (mid 850, step 4), 990-1100 (mid 1045: outside every span)
    assert got == pytest.approx({"decode_step": 210e-9, "outside": 110e-9,
                                 "stop_check": 80e-9, "generate_report": 10e-9})
    assert list(got) == ["decode_step", "outside", "stop_check", "generate_report"]
    assert tracing.idle_by_span([], spans) == {}


def test_profile_writes_its_trace_and_names_the_gaps(models, tmp_path):
    with tracing.profile(str(tmp_path)) as trace:
        with tracing.span("train_step"):
            out = torch.ones(4) * 2
    assert out.tolist() == [2.0] * 4
    assert {e.key for e in trace.session.key_averages()} >= {"cxr.train_step"}
    assert trace.idle_by_span == {}  # no device here: no gaps
    names = sorted(os.listdir(tmp_path))
    assert names == [f"idle_by_span_{os.getpid()}.json", f"trace_{os.getpid()}.json"]
    assert tracing.requests()[-1][0].name == "train_step"


@pytest.mark.parametrize("variant,beams", CASES)
def test_recording_changes_no_token(models, variant, beams):
    model = models[variant]
    hidden, mask = model.encode(pixels())
    prompt = torch.full((3, 1), model.tokenizer.bos_token_id, dtype=torch.int32)
    cfg = model._gen_cfg(beams, NEW)

    def decode():
        if beams > 1:
            return beam_search(model.model, cfg, hidden, mask, prompt, prompt)[0]
        return generate(model.model, cfg, hidden, mask, prompt, prompt)

    def traced_decode():
        with tracing.span("decode"):  # one request around the loop's spans
            return decode()

    off = decode()
    on, spans, _ = recorded(traced_decode)
    assert torch.equal(on, off) and [s.name for s in spans[:2]] == ["decode", "prefill"]
    assert recorded(lambda: report(model, beams))[0] == report(model, beams)


@pytest.mark.cuda
def test_host_reads_are_torch_synchronising_calls_on_card(tmp_path):
    """Greedy (pixels on the card) and beam-4 with prompts (pixels copied
    from the host) at 8 studies of 5 slots at the published widths: the
    program's ``host_read`` count of a request equals the synchronising
    calls torch reports under ``set_sync_debug_mode("warn")``; a CUDA-only
    session records the spans; the spans lie within their ranges on the
    card's clock; ``encode`` has its stream time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tok = ByteLevelBPETokenizer.from_file(TOKENIZER)
    findings = ["Heart size is normal. No focal consolidation.", None] * 4
    impression = ["No acute cardiopulmonary process.", None] * 4
    for variant, beams, on_card in [("multi", 1, True), ("longitudinal", 4, False)]:
        model = CXRMate.random_init(tok, variant=variant, dtype=torch.bfloat16, device="cuda")
        px = pixels("cuda" if on_card else "cpu", torch.bfloat16 if on_card else torch.float32,
                    studies=8, slots=5, size=384)
        kw = dict(num_beams=beams, max_new_tokens=8)
        if variant == "longitudinal":
            kw.update(previous_findings=findings, previous_impression=impression)
        model.generate_report(px, **kw)  # builds the kernels
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    model.generate_report(px, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        spans = tracing.requests()[-1]
        reads = sum(s.counts.get("host_read", 0) for s in spans)
        steps = sum(s.counts.get("decode_steps", 0) for s in spans)
        by_span = Counter()
        for s in spans:
            by_span[s.name] += s.counts.get("host_read", 0)
        print(f"{variant} beams={beams}: torch syncs {syncs}, host_read {reads}, steps {steps}, "
              f"by span {dict(+by_span)}")
        assert spans[0].name == "generate_report" and steps >= 1
        assert syncs == reads
        encode = next(s for s in spans if s.name == "encode")
        assert encode.device_ms > 0 and encode.counts["images"] == 40
        _, spans, prof = recorded(lambda: model.generate_report(px, **kw))
        ranges = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.name().startswith(tracing.PREFIX)
                         and str(e.device_type()).endswith("CPU")), key=lambda e: e.start_ns())
        assert [e.name() for e in ranges] == [tracing.PREFIX + s.name for s in spans]
        worst = max(max(e.start_ns() - s.t0, s.t1 - e.start_ns() - e.duration_ns())
                    for e, s in zip(ranges, spans))
        print(f"{variant}: worst span outside its range by {worst} ns")
        assert worst <= CLOCK_NS
        with tracing.profile(str(tmp_path / variant)) as trace:
            model.generate_report(px, **kw)
        idle = trace.idle_by_span
        print(f"{variant}: idle_by_span {idle}")
        assert set(idle) <= {s.name for s in tracing.requests()[-1]} | {"outside"}
        assert idle.get("outside", 0.0) < 0.5 * sum(idle.values())  # one clock with the card's
        del model
        torch.cuda.empty_cache()
