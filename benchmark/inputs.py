"""The general generator of served studies: reads a traffic mix's parameters
and makes, from the seed, the same inputs every time.

A mix fixes the work of a batch and the seed only orders it: the number of
studies with 1, 2, ... images is the mix's shares apportioned to the batch
(largest remainders), and the previous reports' lengths are a fixed ladder
from ``min_tokens`` to ``max_tokens`` with ``none_share`` of the studies
without one; the seed permutes both and draws the pixels and the words.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def apportion(shares: Dict[str, float], n: int) -> Dict[int, int]:
    """Counts of each key (an int as a string) among n, largest remainders
    first (ties to the smaller key); they sum to n."""
    keys = sorted(int(k) for k in shares)
    total = sum(shares[str(k)] for k in keys)
    exact = [n * shares[str(k)] / total for k in keys]
    counts = [int(np.floor(x)) for x in exact]
    order = sorted(range(len(keys)), key=lambda i: (-(exact[i] - counts[i]), keys[i]))
    for i in order[: n - sum(counts)]:
        counts[i] += 1
    return dict(zip(keys, counts))


def images_per_study(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    counts = apportion(mix["images_per_study"], n)
    ladder = np.concatenate([np.full(c, k) for k, c in counts.items()]).astype(np.int64)
    return rng.permutation(ladder)


def prompt_lengths(mix: dict, n: int, rng: np.random.Generator) -> List[Optional[int]]:
    """Token counts of the previous reports (None: no previous report)."""
    spec = mix["previous_report"]
    none = int(round(n * spec["none_share"]))
    k = n - none
    ladder = [int(round(x)) for x in np.linspace(spec["min_tokens"], spec["max_tokens"], k)]
    out = [None] * none + ladder
    return [out[i] for i in rng.permutation(n)]


def make_pixels(counts: Sequence[int], slots: int, size: int, seed: int, device,
                dtype=torch.bfloat16) -> torch.Tensor:
    """[B, slots, 3, size, size] standard-normal images on the device, the
    slots past each study's count all-zero (the loaders' padding). A real
    image's pixel [0, 0, 0] is never exactly 0 (that marks padding)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b = len(counts)
    px = torch.randn((b, slots, 3, size, size), generator=gen, device=device, dtype=dtype)
    real = (torch.arange(slots, device=device)[None, :]
            < torch.as_tensor(list(counts), device=device)[:, None])
    px.mul_(real[:, :, None, None, None].to(dtype))
    corner = px[:, :, 0, 0, 0]
    corner.copy_(torch.where(real & (corner == 0), torch.ones_like(corner), corner))
    return px


def ordinary_ids(tok) -> np.ndarray:
    special = {tok.vocab[t] for t in tok.all_special_tokens}
    return np.array([i for i in range(len(tok)) if i not in special])


def make_section(tok, ordinary: np.ndarray, rng: np.random.Generator, n_tokens: int) -> str:
    """Text decoded from ``n_tokens`` random ordinary ids; it encodes to
    about that many tokens."""
    return tok.decode([int(i) for i in rng.choice(ordinary, n_tokens)])


def make_prompts(tok, lengths: Sequence[Optional[int]], rng: np.random.Generator
                 ) -> Tuple[List[Optional[str]], List[Optional[str]]]:
    """Previous findings and impressions: a report of n tokens is n - 3 words'
    worth ([PMT], [PMT-SEP] and [BOS] make up the rest), two thirds findings."""
    ordinary = ordinary_ids(tok)
    findings, impression = [], []
    for n in lengths:
        if n is None:
            findings.append(None)
            impression.append(None)
            continue
        body = max(n - 3, 2)
        findings.append(make_section(tok, ordinary, rng, body * 2 // 3))
        impression.append(make_section(tok, ordinary, rng, body - body * 2 // 3))
    return findings, impression


def make_batch(mix: dict, cfg: dict, tok, seed: int, index: int, device) -> dict:
    """Batch ``index`` of the pool that ``seed`` makes: pixels, image counts,
    previous reports (longitudinal only), and the studies that the output
    check samples (the batch's longest request first)."""
    rng = np.random.default_rng([seed, index])
    n = mix["studies_per_batch"]
    counts = images_per_study(mix, n, rng)
    batch = {"counts": counts, "prompts": None, "lengths": [0] * n}
    if cfg["variant"] == "longitudinal":
        lengths = prompt_lengths(mix, n, rng)
        batch["prompts"] = make_prompts(tok, lengths, rng)
        batch["lengths"] = [x or 0 for x in lengths]
    longest = int(np.argmax(batch["lengths"]))
    rest = [i for i in rng.permutation(n) if i != longest]
    batch["check_rows"] = sorted([longest] + [int(i) for i in rest[: mix["check_studies"] - 1]])
    batch["check_rows_t"] = torch.as_tensor(batch["check_rows"], device=device)
    batch["pixels"] = make_pixels(counts, cfg["max_images_per_study"], cfg["image_size"],
                                  int(rng.integers(2 ** 62)), device,
                                  getattr(torch, cfg["dtype"]))
    return batch
