"""The general generator is seeded and gives each mix its parameters."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.kinds.serve import load_tokenizer
from benchmark.tests.conftest import tiny_config
from benchmark.manifest import Bench


@pytest.fixture(scope="module")
def bench():
    return Bench()


def test_apportion_sums_and_hits_the_shares():
    counts = inputs.apportion({"1": 0.44, "2": 0.49, "3": 0.05, "4": 0.013, "5": 0.007}, 64)
    assert counts == {1: 28, 2: 31, 3: 3, 4: 1, 5: 1}
    assert sum(counts.values()) == 64


@pytest.mark.parametrize("traffic,n", [("beam4.b256", 256), ("greedy.b512", 512)])
def test_image_fill(bench, traffic, n):
    mix = bench.traffic(traffic)
    assert mix["studies_per_batch"] == n
    a = inputs.images_per_study(mix, n, np.random.default_rng(1))
    b = inputs.images_per_study(mix, n, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)  # same work, another order
    assert 1 <= a.min() and a.max() <= 5
    assert abs(a.mean() - 1.66) < 0.035  # MIMIC-CXR-JPG: 377,110 images / 227,835 studies


def test_prompt_lengths(bench):
    mix = bench.traffic("beam4.b256")
    lengths = inputs.prompt_lengths(mix, 256, np.random.default_rng(3))
    none = sum(x is None for x in lengths)
    assert none == round(256 * 0.287)
    real = [x for x in lengths if x is not None]
    assert min(real) == 24 and max(real) == 300


def test_pixels_padding_and_seed():
    a = inputs.make_pixels([1, 3, 5], 5, 16, 7, "cpu", torch.float32)
    b = inputs.make_pixels([1, 3, 5], 5, 16, 7, "cpu", torch.float32)
    assert torch.equal(a, b)
    real = a[:, :, 0, 0, 0] != 0
    assert real.tolist() == [[True] + [False] * 4, [True] * 3 + [False] * 2, [True] * 5]
    assert (a[0, 1:] == 0).all()


def test_batch_is_seeded_and_prompts_bucket_to_256(bench):
    cfg = tiny_config("cxrmate-longitudinal")
    tok = load_tokenizer(cfg)
    mix = bench.traffic("beam4.b256")
    a = inputs.make_batch(mix, cfg, tok, 2 ** 31 + 5, 0, "cpu")
    b = inputs.make_batch(mix, cfg, tok, 2 ** 31 + 5, 0, "cpu")
    assert a["prompts"] == b["prompts"] and torch.equal(a["pixels"], b["pixels"])
    assert a["check_rows"] == b["check_rows"] and len(a["check_rows"]) == mix["check_studies"]
    assert int(np.argmax(a["lengths"])) in a["check_rows"]  # the longest request is judged
    findings, impression = a["prompts"]
    assert sum(f is None for f in findings) == round(256 * 0.287)
    widths = [len(tok.encode(f"[PMT]{f}[PMT-SEP]{i}[BOS]")) for f, i in zip(findings, impression)
              if f is not None]
    assert max(widths) > 256  # the longest is truncated: every batch's bucket is 256
    assert min(widths) < 48


def test_reference_prompt_agrees_with_the_port(bench):
    """The reference's prompt of a whole batch (``reference.prompt``) is the
    program's (``tokenize_prompt`` then ``bucket_prompt``), id for id."""
    from cxrmate_torch.models import encoder_decoder as ed

    from benchmark.reference import prompt

    cfg = tiny_config("cxrmate-longitudinal")
    tok = load_tokenizer(cfg)
    for seed in (2 ** 31 + 6, 17):
        batch = inputs.make_batch(bench.traffic("beam4.b256"), cfg, tok, seed, 1, "cpu")
        got = ed.tokenize_prompt(*batch["prompts"], tok, cfg["prompt_max_len"], True)
        ids, mask = ed.bucket_prompt(got["input_ids"], got["attention_mask"], tok.pad_token_id,
                                     32, cfg["prompt_max_len"])
        want, first_col = prompt.prompt_ids(cfg, batch["prompts"], 256)
        assert torch.equal(want, torch.as_tensor(ids, dtype=torch.long))
        assert first_col == got["input_ids"].shape[1] - 1
    multi = tiny_config("cxrmate-multi")
    bos, _ = prompt.prompt_ids(multi, None, 3)
    assert bos.tolist() == [[tok.bos_token_id]] * 3


def test_reference_tokenizer_agrees_with_hf_tokenizers(bench):
    """The reference's byte-level BPE against HF ``tokenizers`` on the
    generator's prompts and on random text with every character class."""
    import random

    from benchmark.reference import prompt

    tokenizers = pytest.importorskip("tokenizers")
    cfg = tiny_config("cxrmate-longitudinal")
    hf = tokenizers.Tokenizer.from_file(prompt.os.path.join(prompt.CONFIGS, cfg["tokenizer"]))
    bpe = prompt.tokenizer(cfg["tokenizer"])
    batch = inputs.make_batch(bench.traffic("beam4.b256"), cfg, load_tokenizer(cfg), 5, 0, "cpu")
    texts = prompt.prompt_texts(cfg["prompt"], *batch["prompts"])
    rng = random.Random(0)
    alphabet = [chr(c) for c in [*range(0x250), 0x1680, 0x2000, 0x2028, 0x3000, 0xb2, 0xfffd]]
    alphabet += ["'s", "'ll", "  ", "[PMT]", "[BOS]"]
    texts += ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40))) for _ in range(300)]
    for text in texts:
        assert bpe.encode(text) == hf.encode(text).ids, repr(text)
