"""WordPiece (BERT) tokenizer of the CXR-BERT reward and, later, the CheXbert
labeler: the port's own copy of ``cxrmate_tpu/tokenizer/wordpiece.py:43
WordPieceTokenizer``, pure Python. HF ``BertTokenizer``'s pipeline: basic
tokenisation (cleaning, CJK spacing, lower-casing and accent stripping for
uncased models, punctuation splitting), then greedy longest-match WordPiece
with ``##`` continuations. ``__call__`` returns numpy int32 arrays, as the JAX
package's does; truncation at ``max_length`` keeps the final ``[SEP]``."""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.max_input_chars_per_word = max_input_chars_per_word

    @classmethod
    def from_file(cls, vocab_path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    # ---- basic tokenizer ----
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_basic(self, text: str) -> List[str]:
        text = self._clean(text)
        text = "".join(
            f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text
        )
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # ---- wordpiece ----
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for tok in self._split_basic(text):
            pieces.extend(self._wordpiece(tok))
        return pieces

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.vocab[self.unk_token]) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.vocab[self.cls_token]] + ids + [self.vocab[self.sep_token]]
        return ids

    def __call__(
        self,
        texts: Sequence[str],
        padding: str = "longest",
        truncation: bool = False,
        max_length: Optional[int] = None,
        add_special_tokens: bool = True,
    ) -> Dict[str, np.ndarray]:
        encoded = [self.encode(t, add_special_tokens) for t in texts]
        if truncation and max_length is not None:
            # BertTokenizer truncates, then appends the specials: cut to
            # max_length and keep the final [SEP]
            cut = []
            sep_id = self.vocab[self.sep_token]
            for e in encoded:
                if len(e) > max_length:
                    e = e[: max_length - 1] + [sep_id] if add_special_tokens else e[:max_length]
                cut.append(e)
            encoded = cut
        width = max((len(e) for e in encoded), default=0)
        if padding == "max_length" and max_length:
            width = max_length
        pad_id = self.pad_token_id
        n = len(encoded)
        input_ids = np.full((n, width), pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, width), dtype=np.int32)
        token_type_ids = np.zeros((n, width), dtype=np.int32)
        for r, e in enumerate(encoded):
            input_ids[r, : len(e)] = e
            attention_mask[r, : len(e)] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
        }
