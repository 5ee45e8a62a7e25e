"""Work and operation counts against hand counts and PyTorch's counter."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import decoder_logits, encode_images
from benchmark.tests.conftest import tiny_config
from benchmark.weights import make_state_dict
from benchmark.work import beam_reorder, decode_attention, model


def test_decode_attention_by_hand():
    # q [2, 3, 4, 8] bf16; mask [2, 10] with 7 unmasked (row, key) pairs
    nbytes, flops = decode_attention.work((2, 3, 4, 8), 2, 20, 7)
    assert nbytes == 2 * (2 * 3 * 4 * 8) * 2 + 7 * 3 * 2 * 8 * 2 + 20 * 4
    assert flops == 4 * 7 * 3 * 4 * 8


def test_beam_reorder_by_hand():
    # 8 rows, 2 heads, 5 columns, head width 4, bf16; 3 rows move
    row, col = 2 * 5 * 4 * 2, 2 * 4 * 2
    assert beam_reorder.work((8, 2, 5, 4), 2, 3, True) == 2 * (3 * 2 * row + 5 * 2 * col) + 8 * 4
    assert beam_reorder.work((8, 2, 5, 4), 2, 3, False) == 2 * (3 * 2 * row) + 8 * 4


@pytest.mark.parametrize("size", [32, 48])
def test_cvt_operations_match_the_counter(size):
    cfg = tiny_config("cxrmate-multi")
    cfg["image_size"] = size
    sd = {k: v.float() for k, v in make_state_dict(cfg, 1, "cpu").items()}
    with FlopCounterMode(display=False) as fc:
        encode_images(sd, cfg, torch.randn(3, 3, size, size))
    assert fc.get_total_flops() == 3 * model.cvt_image(cfg["encoder"], size)


def test_cvt21_at_384():
    import json
    import os

    from benchmark.tests.conftest import REPO
    with open(os.path.join(REPO, "benchmark", "configs", "cxrmate-multi.json")) as f:
        cfg = json.load(f)
    assert model.cvt_image(cfg["encoder"], 384) == pytest.approx(50.04e9, rel=1e-3)  # 25 GMAC


@pytest.mark.parametrize("name", ["cxrmate-multi", "cxrmate-longitudinal"])
def test_decoder_token_by_hand(name):
    cfg = tiny_config(name)
    d, ff, v, layers = 32, 64, cfg["decoder"]["vocab_size"], 2
    lora = 8 * d * cfg["lora"]["r"] if cfg["lora"] else 0
    per_layer = 8 * d * d + 4 * d * 5 + 4 * d * d + 4 * d * 7 + 4 * d * ff + lora
    got = model.decoder_token(cfg["decoder"], cfg["lora"], 5, 7)
    assert got == layers * per_layer + 2 * d * d + 2 * d * v


@pytest.mark.parametrize("name", ["cxrmate-multi", "cxrmate-longitudinal"])
def test_decoder_operations_match_the_counter(name):
    """A dense forward over L tokens: each of the L rows attends to all L
    keys (the causal mask is additive), and the study's cross K/V once."""
    cfg = tiny_config(name)
    sd = {k: v.float() for k, v in make_state_dict(cfg, 2, "cpu").items()}
    l, s = 6, 9
    ids = torch.randint(5, 100, (1, l))
    with FlopCounterMode(display=False) as fc:
        decoder_logits(sd, cfg, ids, torch.ones(1, l), torch.zeros(1, l, dtype=torch.long),
                       torch.arange(l)[None], torch.randn(1, s, 32), torch.ones(1, s))
    dec = cfg["decoder"]
    want = l * model.decoder_token(dec, cfg["lora"], l, s) + model.cross_kv(dec, 32, s)
    assert fc.get_total_flops() == want
