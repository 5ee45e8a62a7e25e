"""Byte-level BPE tokenizer: the port's own copy of the Python encoder.

Copy of ``cxrmate_tpu/tokenizer/bpe.py:61 ByteLevelBPETokenizer`` (HF
``tokenizers`` BPE + ByteLevel pre-tokenizer and decoder, specials
``[UNK][BOS][EOS][SEP][PAD][MASK]`` plus the ``bpe_prompt`` extras), reading
HF ``tokenizer.json``. Only the Python encoder: no native fast path. Encoding
needs the ``regex`` package, imported at first use; decoding does not.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# The GPT-2 / ByteLevel pre-tokenization pattern (HF tokenizers `ByteLevel.use_regex`).
_BYTE_LEVEL_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@functools.lru_cache(maxsize=1)
def _byte_level_split_re():
    try:
        import regex
    except ImportError as e:
        raise RuntimeError("the `regex` package is required to encode byte-level BPE") from e
    return regex.compile(_BYTE_LEVEL_PATTERN)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map (matches HF ByteLevel)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class ByteLevelBPETokenizer:
    """HF-compatible byte-level BPE with added special tokens.

    The surface the serving path uses: ``encode``, the batch call with
    longest padding and truncation, ``decode(skip_special_tokens=True)``,
    ``bos/eos/sep/pad/mask`` token ids and ``additional_special_tokens``.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Sequence[str] = ("[UNK]", "[BOS]", "[EOS]", "[SEP]", "[PAD]", "[MASK]"),
        additional_special_tokens: Sequence[str] = (),
        unk_token: Optional[str] = None,
    ):
        # unk_token mirrors the BPE *model*'s unk (tokenizer.json model.unk_token),
        # NOT the [UNK] special: the reference trains `tokenizers.models.BPE()`
        # (examples/tokenizer.ipynb), whose model unk is null — byte symbols
        # absent from the vocab are DROPPED before merging (so their neighbours
        # become adjacent and may merge), not mapped to [UNK].
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.merges = list(merges)
        self.bpe_ranks = {pair: i for i, pair in enumerate(self.merges)}
        self.unk_token = unk_token

        self.special_tokens = list(special_tokens)
        self.additional_special_tokens = list(additional_special_tokens)
        for tok in self.all_special_tokens:
            if tok not in self.vocab:
                raise ValueError(f"special token {tok!r} missing from vocab")
        self._special_ids = {self.vocab[t] for t in self.all_special_tokens}

        # Specials are matched greedily before pre-tokenization (longest first, like
        # the HF added-tokens trie).
        self._specials_sorted = sorted(self.all_special_tokens, key=len, reverse=True)

        self._cache: Dict[str, List[str]] = {}

    # -- special-token properties matching PreTrainedTokenizerFast ------------
    @property
    def all_special_tokens(self) -> List[str]:
        seen = []
        for t in self.special_tokens + self.additional_special_tokens:
            if t not in seen:
                seen.append(t)
        return seen

    def _tok_id(self, token: str) -> int:
        return self.vocab[token]

    @property
    def unk_token_id(self) -> Optional[int]:
        return None if self.unk_token is None else self._tok_id(self.unk_token)

    @property
    def bos_token_id(self) -> int:
        return self._tok_id("[BOS]")

    @property
    def eos_token_id(self) -> int:
        return self._tok_id("[EOS]")

    @property
    def sep_token_id(self) -> int:
        return self._tok_id("[SEP]")

    @property
    def pad_token_id(self) -> int:
        return self._tok_id("[PAD]")

    @property
    def mask_token_id(self) -> int:
        return self._tok_id("[MASK]")

    bos_token = "[BOS]"
    eos_token = "[EOS]"
    sep_token = "[SEP]"
    pad_token = "[PAD]"
    mask_token = "[MASK]"

    @property
    def additional_special_tokens_ids(self) -> List[int]:
        return [self.vocab[t] for t in self.additional_special_tokens]

    def __len__(self) -> int:
        return len(self.vocab)

    # -- core BPE --------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Apply BPE merges to one byte-level-encoded pre-token."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        if len(word) > 1:
            ranks = self.bpe_ranks
            while True:
                best_rank = None
                best_i = -1
                for i in range(len(word) - 1):
                    r = ranks.get((word[i], word[i + 1]))
                    if r is not None and (best_rank is None or r < best_rank):
                        best_rank, best_i = r, i
                if best_rank is None:
                    break
                merged = word[best_i] + word[best_i + 1]
                word[best_i : best_i + 2] = [merged]
        if len(self._cache) < 65536:
            self._cache[token] = word
        return word

    def _split_on_specials(self, text: str) -> List[Tuple[str, bool]]:
        """Split text into (piece, is_special) chunks, longest-special-first."""
        chunks: List[Tuple[str, bool]] = [(text, False)]
        for sp in self._specials_sorted:
            next_chunks: List[Tuple[str, bool]] = []
            for piece, is_special in chunks:
                if is_special or sp not in piece:
                    next_chunks.append((piece, is_special))
                    continue
                start = 0
                while True:
                    idx = piece.find(sp, start)
                    if idx < 0:
                        if start < len(piece):
                            next_chunks.append((piece[start:], False))
                        break
                    if idx > start:
                        next_chunks.append((piece[start:idx], False))
                    next_chunks.append((sp, True))
                    start = idx + len(sp)
            chunks = next_chunks
        return chunks

    def encode(self, text: str) -> List[int]:
        """Encode text to token ids (no implicit specials, like the reference which
        always tokenizes with ``add_special_tokens=False``)."""
        b2u = bytes_to_unicode()
        split = _byte_level_split_re()
        ids: List[int] = []
        unk = None if self.unk_token is None else self.vocab.get(self.unk_token)
        vocab = self.vocab
        for piece, is_special in self._split_on_specials(text):
            if is_special:
                ids.append(vocab[piece])
                continue
            for m in split.finditer(piece):
                mapped = "".join(b2u[b] for b in m.group().encode("utf-8"))
                if unk is None:
                    # HF BPE with model unk null: unknown symbols are dropped
                    # BEFORE merging ("aXb" → ["ab"] when the merge exists)
                    mapped = "".join(ch for ch in mapped if ch in vocab)
                    if not mapped:
                        continue
                    for tok in self._bpe(mapped):
                        tid = vocab.get(tok)
                        # a merge output missing from the vocab (malformed
                        # merge table) is dropped, not a crash
                        if tid is not None:
                            ids.append(tid)
                else:
                    for tok in self._bpe(mapped):
                        ids.append(vocab.get(tok, unk))
        return ids

    def decode(self, token_ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        u2b = unicode_to_bytes()
        parts: List[str] = []
        for i in token_ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            parts.append(tok)
        buf = bytearray()
        for tok in parts:
            if tok in self.vocab and self.vocab[tok] in self._special_ids:
                # kept special: splice raw text
                buf.extend(tok.encode("utf-8"))
            else:
                for ch in tok:
                    b = u2b.get(ch)
                    if b is not None:
                        buf.append(b)
                    else:
                        buf.extend(ch.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    def __call__(self, texts: Sequence[str], padding: str = "longest", truncation: bool = False,
                 max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Batch encode with longest (or ``"max_length"``) padding and
        truncation, as the reference's ``tokenizer(report, padding='longest',
        truncation=True, max_length=...)`` calls. Returns int32 numpy arrays
        ``input_ids`` and ``attention_mask``."""
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            encoded = [e[:max_length] for e in encoded]
        width = max((len(e) for e in encoded), default=0)
        if padding == "max_length" and max_length is not None:
            width = max_length
        input_ids = np.full((len(encoded), width), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((len(encoded), width), dtype=np.int32)
        for r, e in enumerate(encoded):
            input_ids[r, : len(e)] = e
            attention_mask[r, : len(e)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

    # -- serialization (HF tokenizer.json) --------------------------------------
    @classmethod
    def from_file(cls, path: str) -> "ByteLevelBPETokenizer":
        """Load from an HF ``tokenizer.json`` (or a directory containing one)."""
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        with open(path) as f:
            data = json.load(f)
        model = data["model"]
        if model["type"] != "BPE":
            raise ValueError(f"unsupported tokenizer model {model['type']!r}")
        vocab = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        added = data.get("added_tokens", [])
        specials = [t["content"] for t in added if t.get("special")]
        base = ["[UNK]", "[BOS]", "[EOS]", "[SEP]", "[PAD]", "[MASK]"]
        additional = [t for t in specials if t not in base]
        for t in specials:
            vocab.setdefault(t, next(iter([a["id"] for a in added if a["content"] == t])))
        return cls(
            vocab=vocab,
            merges=merges,
            special_tokens=[t for t in base if t in vocab],
            additional_special_tokens=additional,
            unk_token=model.get("unk_token"),
        )
