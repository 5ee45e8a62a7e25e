"""Fixtures of the benchmark's tests. Whether a card is present is decided
inside the ``card`` fixture, never while a module is imported."""

import copy
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the port on the card)")
    return torch.device("cuda")


def tiny_config(name: str) -> dict:
    """A configuration file's model at the widths a CPU test can hold, every
    rule and key kept."""
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["encoder"].update(embed_dim=[16, 24, 32], num_heads=[1, 1, 2], depth=[1, 1, 2],
                          projection_size=32)
    cfg["decoder"].update(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                          num_hidden_layers=2)
    cfg["image_size"] = 32
    return cfg


def tiny_mix(name: str, **over) -> dict:
    with open(os.path.join(REPO, "benchmark", "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix.update(studies_per_batch=6, max_new_tokens=10, pool_batches=2, check_studies=6)
    mix.update(over)
    return mix


def limits(cell: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)


# (config, traffic, cell) of each served cell
SERVED = [("cxrmate-longitudinal", "beam4.b256", "longitudinal.beam4.b256"),
          ("cxrmate-multi", "greedy.b512", "multi.greedy.b512")]
