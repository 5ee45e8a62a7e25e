"""Byte-level BPE tokenizer: the port's own copy of the Python encoder.

Copy of ``cxrmate_tpu/tokenizer/bpe.py:61 ByteLevelBPETokenizer`` (HF
``tokenizers`` BPE + ByteLevel pre-tokenizer and decoder, specials
``[UNK][BOS][EOS][SEP][PAD][MASK]`` plus the ``bpe_prompt`` extras), reading
and writing HF ``tokenizer.json``, and ``train_bpe``, the copy of
``cxrmate_tpu/tokenizer/train.py``. The native C++ encoder is opt-in
(``tokenizer/native_binding.py:attach``), as in JAX; this Python encoder is
its oracle. Encoding and training need the ``regex`` package, imported at
first use; decoding and the native encoder do not.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
from collections import Counter, defaultdict
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
    longest padding and truncation, ``decode(skip_special_tokens=True)`` and
    ``batch_decode``, ``bos/eos/sep/pad/mask`` token ids and
    ``additional_special_tokens``; ``save`` writes ``tokenizer.json``.
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
        self._native = None  # the C++ encoder, once attached

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

    def attach_native(self, native) -> None:
        """Attach a C++ encoder implementing ``encode(text) -> List[int]``."""
        self._native = native

    def encode(self, text: str) -> List[int]:
        """Encode text to token ids (no implicit specials, like the reference which
        always tokenizes with ``add_special_tokens=False``); through the
        native encoder once one is attached."""
        if self._native is not None:
            return self._native.encode(text)
        return self._encode_py(text)

    def _encode_py(self, text: str) -> List[int]:
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

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]

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

    def save(self, path: str) -> None:
        """Write an HF-compatible ``tokenizer.json`` (``path`` a file, or a
        directory to write it into), as ``cxrmate_tpu/tokenizer/bpe.py:319``
        writes it."""
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "tokenizer.json")
        added = [{"id": self.vocab[t], "content": t, "single_word": False, "lstrip": False,
                  "rstrip": False, "normalized": False, "special": True}
                 for t in self.all_special_tokens]
        byte_level = {"add_prefix_space": False, "trim_offsets": True, "use_regex": True}
        data = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", **byte_level},
            "post_processor": None,
            "decoder": {"type": "ByteLevel", **byte_level, "add_prefix_space": True},
            "model": {
                "type": "BPE",
                "dropout": None,
                "unk_token": self.unk_token,
                "continuing_subword_prefix": None,
                "end_of_word_suffix": None,
                "fuse_unk": False,
                "byte_fallback": False,
                "ignore_merges": False,
                "vocab": self.vocab,
                "merges": [list(m) for m in self.merges],
            },
        }
        with open(path, "w") as f:
            json.dump(data, f, ensure_ascii=False)


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 30000,
    min_frequency: int = 0,
    special_tokens: Sequence[str] = ("[UNK]", "[BOS]", "[EOS]", "[SEP]", "[PAD]", "[MASK]"),
    additional_special_tokens: Sequence[str] = (),
) -> ByteLevelBPETokenizer:
    """Train a byte-level BPE tokenizer: the port's copy of
    ``cxrmate_tpu/tokenizer/train.py:25 train_bpe`` (HF ``tokenizers``' BPE
    trainer: the pair of highest count first, ties to the smallest ``(left_id,
    right_id)``). ``additional_special_tokens`` are appended to the vocab after
    training (as the `bpe_prompt` tokenizer gained ``[NPF][NPI][PMT][PMT-SEP]``)."""
    b2u = bytes_to_unicode()
    split = _byte_level_split_re()

    # 1. Pre-tokenize and count words (byte-level mapped).
    word_counts: Counter = Counter()
    for text in texts:
        for m in split.finditer(text):
            word_counts["".join(b2u[b] for b in m.group().encode("utf-8"))] += 1

    # 2. Vocab starts with the specials, then the sorted alphabet.
    vocab: Dict[str, int] = {}
    for tok in special_tokens:
        vocab.setdefault(tok, len(vocab))
    alphabet = sorted({ch for w in word_counts for ch in w})
    for ch in alphabet:
        vocab.setdefault(ch, len(vocab))

    # 3. Represent each distinct word as a list of symbol ids.
    words: List[List[int]] = []
    counts: List[int] = []
    for w, c in word_counts.items():
        words.append([vocab[ch] for ch in w])
        counts.append(c)

    # 4. Count adjacent pairs and where they occur.
    pair_counts: Dict[Tuple[int, int], int] = defaultdict(int)
    pair_words: Dict[Tuple[int, int], set] = defaultdict(set)
    for wi, w in enumerate(words):
        c = counts[wi]
        for a, b in zip(w, w[1:]):
            pair_counts[(a, b)] += c
            pair_words[(a, b)].add(wi)

    # Lazy max-heap keyed by (-count, pair): HF breaks count ties on the smallest pair.
    heap = [(-c, p) for p, c in pair_counts.items() if c > 0]
    heapq.heapify(heap)

    id_to_token = {i: t for t, i in vocab.items()}
    merges: List[Tuple[str, str]] = []
    min_frequency = max(min_frequency, 1)

    while len(vocab) < vocab_size and heap:
        neg, pair = heapq.heappop(heap)
        current = pair_counts.get(pair, 0)
        if current != -neg:
            if current > 0:
                heapq.heappush(heap, (-current, pair))
            continue
        if current < min_frequency:
            break

        a, b = pair
        new_token = id_to_token[a] + id_to_token[b]
        new_id = vocab.setdefault(new_token, len(vocab))
        id_to_token[new_id] = new_token
        merges.append((id_to_token[a], id_to_token[b]))

        # Apply the merge in every word containing the pair: subtract the word's old
        # pair counts, rebuild the word, add the new ones.
        touched: Dict[Tuple[int, int], int] = defaultdict(int)
        for wi in list(pair_words[pair]):
            w = words[wi]
            c = counts[wi]
            if len(w) < 2:
                continue
            for p in zip(w, w[1:]):
                touched[p] -= c
            out: List[int] = []
            i, n = 0, len(w)
            while i < n:
                if i + 1 < n and w[i] == a and w[i + 1] == b:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            for p in zip(out, out[1:]):
                touched[p] += c
                pair_words[p].add(wi)

        for p, delta in touched.items():
            if delta == 0:
                continue
            nc = pair_counts.get(p, 0) + delta
            pair_counts[p] = nc
            if nc > 0 and p != pair:
                heapq.heappush(heap, (-nc, p))
        pair_counts[pair] = 0

    for tok in additional_special_tokens:
        vocab.setdefault(tok, len(vocab))

    return ByteLevelBPETokenizer(
        vocab=vocab,
        merges=merges,
        special_tokens=list(special_tokens),
        additional_special_tokens=list(additional_special_tokens),
    )
