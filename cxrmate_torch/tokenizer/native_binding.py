"""The native (C++) BPE encoder, opt-in, as in the JAX package.

The port's copy of ``cxrmate_tpu/tokenizer/native_binding.py``:
``attach(tokenizer)`` builds ``tokenizer/native/bpe.cpp`` (with the committed
``unicode_tables.h``, so the build needs no ``regex``) into
``cxrmate_torch/_build/bpe-<hash>/`` (``utils/host_build.py``) and plugs a
native ``encode`` into a :class:`ByteLevelBPETokenizer`. Vocab tokens are
translated from the GPT-2 printable-unicode alphabet back to raw bytes, so
the C++ engine works on byte strings. Where the JAX function returns None on
a failed build, this one raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List

import numpy as np

from cxrmate_torch.tokenizer.bpe import ByteLevelBPETokenizer, unicode_to_bytes
from cxrmate_torch.utils.host_build import build_library

HERE = Path(__file__).resolve().parent / "native"
SOURCE = HERE / "bpe.cpp"
TABLES = HERE / "unicode_tables.h"
LIB_NAME = "libcxrmate_bpe.so"
COMPILE_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Path of the encoder library, compiling it first if this source hash
    has not been built. Raises with the compiler's output if it fails."""
    return build_library("bpe", SOURCE, LIB_NAME, COMPILE_FLAGS, headers=(TABLES,))


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.bpe_create.restype = ctypes.c_void_p
            lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i32p, ctypes.c_int32,
                                       i32p, ctypes.c_int32, ctypes.c_int32]
            lib.bpe_encode.restype = ctypes.c_int32
            lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, i32p,
                                       ctypes.c_int32]
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeBPE:
    """A C++ engine holding one tokenizer's vocab and merges."""

    def __init__(self, lib, handle, tokenizer: ByteLevelBPETokenizer):
        self._lib = lib
        self._handle = handle
        self._tok = tokenizer
        self._buf = np.empty(1 << 16, dtype=np.int32)

    def encode_piece(self, piece_bytes: bytes) -> List[int]:
        out = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n = self._lib.bpe_encode(self._handle, piece_bytes, len(piece_bytes), out, self._buf.size)
        if n > self._buf.size:
            self._buf = np.empty(n, dtype=np.int32)
            return self.encode_piece(piece_bytes)
        return self._buf[:n].tolist()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, is_special in self._tok._split_on_specials(text):
            if is_special:
                ids.append(self._tok.vocab[piece])
            else:
                ids.extend(self.encode_piece(piece.encode("utf-8")))
        return ids

    def __del__(self):
        if self._lib is not None:
            self._lib.bpe_free(self._handle)
            self._lib = None


def _token_to_bytes(token: str) -> bytes:
    u2b = unicode_to_bytes()
    if all(ch in u2b for ch in token):
        return bytes(u2b[ch] for ch in token)
    return token.encode("utf-8")  # a token outside the byte-level alphabet


def attach(tokenizer: ByteLevelBPETokenizer) -> NativeBPE:
    """Build and attach the native encoder to ``tokenizer``; -> the binding.
    ``tokenizer.encode`` runs it from then on."""
    lib = _load()
    specials = set(tokenizer.all_special_tokens)
    entries = [(t, i) for t, i in tokenizer.vocab.items() if t not in specials]
    blob = bytearray()
    ids = np.empty(len(entries), dtype=np.int32)
    for row, (tok, idx) in enumerate(entries):
        raw = _token_to_bytes(tok)
        blob += len(raw).to_bytes(4, "little")
        blob += raw
        ids[row] = idx
    merge_ids = np.array([[tokenizer.vocab[a], tokenizer.vocab[b]] for a, b in tokenizer.merges],
                         dtype=np.int32).reshape(-1, 2)
    # unk < 0: the engine drops bytes absent from the vocab (HF BPE with model
    # unk_token null, the reference recipe); >= 0 maps them to unk
    unk = -1 if tokenizer.unk_token is None else tokenizer.vocab.get(tokenizer.unk_token, -1)
    i32p = ctypes.POINTER(ctypes.c_int32)
    handle = lib.bpe_create(bytes(blob), len(blob), ids.ctypes.data_as(i32p), len(entries),
                            merge_ids.ctypes.data_as(i32p), len(tokenizer.merges), unk)
    if not handle:
        raise RuntimeError("the native BPE engine refused the tokenizer's vocab")
    native = NativeBPE(lib, ctypes.c_void_p(handle), tokenizer)
    tokenizer.attach_native(native)
    return native
