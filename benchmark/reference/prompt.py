"""The prompt that a served batch should start from, worked out again from
the studies' previous reports: a plain byte-level BPE encoder over the
configuration's ``tokenizer.json`` (HF ``tokenizers``' BPE model under its
ByteLevel pre-tokenizer, added tokens split out first) and the prompt's
layout as the configuration states it (``prompt``): each study's text, the
placeholders for a missing section, truncation at ``prompt_max_len`` with
[BOS] in the last slot of a row that fills it, right padding to the longest
row, then to a multiple of ``bucket``.

Nothing here imports the program: the pre-tokenizer's character classes are
Unicode's (``unicodedata``), as the GPT-2 pattern reads them.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode's White_Space property, which the pattern's \s reads
WHITE_SPACE = frozenset([*map(chr, range(0x09, 0x0E)), " ", "\x85", "\xa0", "\u1680",
                         *map(chr, range(0x2000, 0x200B)), "\u2028", "\u2029", "\u202f",
                         "\u205f", "\u3000"])


def byte_chars() -> Dict[int, str]:
    """GPT-2's map of each byte to a printable character."""
    keep = [*range(ord("!"), ord("~") + 1), *range(0xA1, 0xAD), *range(0xAE, 0x100)]
    out = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in out:
            out[b] = chr(256 + extra)
            extra += 1
    return out


def char_class(c: str) -> str:
    """'s' white space, 'L' a letter, 'N' a number, 'O' anything else."""
    if c in WHITE_SPACE:
        return "s"
    major = unicodedata.category(c)[0]
    return major if major in "LN" else "O"


def pre_tokenize(text: str) -> List[str]:
    """The GPT-2 pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, read left to right."""
    words, i, n = [], 0, len(text)
    cls = [char_class(c) for c in text]
    while i < n:
        hit = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
        if hit:
            words.append(hit)
            i += len(hit)
            continue
        start = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] != "s" else i
        if cls[start] != "s":
            j = start + 1
            while j < n and cls[j] == cls[start]:
                j += 1
            words.append(text[i:j])
            i = j
            continue
        j = i + 1
        while j < n and cls[j] == "s":
            j += 1
        # \s+(?!\S): the run less its last character where a word follows it
        if j < n and j - i > 1:
            j -= 1
        words.append(text[i:j])
        i = j
    return words


class BPE:
    """The configuration's tokenizer: encode text to ids."""

    def __init__(self, path: str):
        with open(path) as f:
            data = json.load(f)
        model = data["model"]
        if model["type"] != "BPE" or data["pre_tokenizer"]["type"] != "ByteLevel":
            raise ValueError("a byte-level BPE tokenizer is expected")
        if (data["pre_tokenizer"].get("add_prefix_space") or data.get("normalizer")
                or model.get("unk_token") is not None):
            raise ValueError("a prefix space, a normalizer or an unknown token is not handled")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.ranks = {tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m): r
                      for r, m in enumerate(model["merges"])}
        self.added = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
        longest_first = sorted(self.added, key=len, reverse=True)
        self.split = re.compile("(" + "|".join(map(re.escape, longest_first)) + ")")
        self.chars = byte_chars()

    @functools.lru_cache(maxsize=1 << 16)
    def word(self, word: str) -> Tuple[int, ...]:
        mapped = "".join(self.chars[b] for b in word.encode("utf-8"))
        if self.ignore_merges and mapped in self.vocab:
            return (self.vocab[mapped],)
        parts = [c for c in mapped if c in self.vocab]  # no unknown token: dropped
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b)), k) for k, (a, b) in enumerate(zip(parts, parts[1:]))]
            best = min((r for r, _ in pairs if r is not None), default=None)
            if best is None:
                break
            a, b = next((parts[k], parts[k + 1]) for r, k in pairs if r == best)
            merged, k = [], 0
            while k < len(parts):
                if k + 1 < len(parts) and parts[k] == a and parts[k + 1] == b:
                    merged.append(a + b)
                    k += 2
                else:
                    merged.append(parts[k])
                    k += 1
            parts = merged
        return tuple(self.vocab[p] for p in parts)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self.split.split(text):
            if piece in self.added:
                ids.append(self.added[piece])
            elif piece:
                for w in pre_tokenize(piece):
                    ids.extend(self.word(w))
        return ids


@functools.lru_cache(maxsize=4)
def tokenizer(name: str) -> BPE:
    return BPE(os.path.join(CONFIGS, name))


def prompt_texts(spec: dict, findings: Sequence[Optional[str]],
                 impression: Sequence[Optional[str]]) -> List[str]:
    return [spec["layout"].format(findings=f or spec["no_findings"],
                                  impression=i or spec["no_impression"])
            for f, i in zip(findings, impression)]


def prompt_ids(cfg: dict, prompts: Optional[Tuple[Sequence, Sequence]], n: int
               ) -> Tuple[torch.Tensor, int]:
    """[n, width] ids that the batch's decode should start from, and the
    column whose logits choose the first new token (the last real column of
    the longest row). Without a prompt in the configuration: [BOS] alone."""
    bpe = tokenizer(cfg["tokenizer"])
    spec = cfg.get("prompt")
    bos, pad = bpe.added["[BOS]"], bpe.added["[PAD]"]
    if spec is None:
        return torch.full((n, 1), bos, dtype=torch.long), 0
    cap = cfg["prompt_max_len"]
    rows = [bpe.encode(t)[:cap] for t in prompt_texts(spec, *prompts)]
    width = max(len(r) for r in rows)
    if width == cap:
        rows = [r[:-1] + [bos] if len(r) == cap else r for r in rows]
    padded = min(-(-width // spec["bucket"]) * spec["bucket"], cap)
    out = torch.full((n, padded), pad, dtype=torch.long)
    for k, r in enumerate(rows):
        out[k, :len(r)] = torch.as_tensor(r, dtype=torch.long)
    return out, width - 1


def special_ids(cfg: dict) -> Dict[str, int]:
    added = tokenizer(cfg["tokenizer"]).added
    return {"pad": added["[PAD]"], "bos": added["[BOS]"], "eos": added["[EOS]"],
            "sep": added["[SEP]"], "pmt_sep": added["[PMT-SEP]"]}
