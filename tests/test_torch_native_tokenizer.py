"""The port's native (C++) BPE encoder (cxrmate_torch/tokenizer/native_binding.py,
tokenizer/native/bpe.cpp) against the port's Python encoder and the JAX
package's binding (cxrmate_tpu/tokenizer/native_binding.py:attach) over
the JAX package's own engine, compiled apart, on the committed prompt
tokenizer: the hard cases of the JAX package's native test, seeded fuzz
and the synthetic reports give the same ids. Beside them:
bytes outside a vocab and a malformed merge table, a failed build raising
with the compiler's output, and the committed Unicode tables equal to the
JAX package's.
"""

from __future__ import annotations

import hashlib
import os
import random

import pytest
import torch

from cxrmate_torch.data.synthetic import FINDINGS, IMPRESSION
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.tokenizer import native_binding as nb
from cxrmate_torch.utils import host_build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt")

HARD_CASES = [
    "",
    "no change.",
    "[PMT]prior[PMT-SEP]none[BOS]",
    "multi  spaces   and\ttabs\nnewlines",
    "unicode: naïve café — 37.5°C ±2",
    "numbers 12345 and mixed a1b2",
    "trailing space ",
    " leading",
    "it's we're can't I'll you've he'd I'm",
    "emoji 🙂 bytes",
    "\n\n",
    "a b",
    "no肺change.",
    "pleural🫁effusion",
    "心心心心心",
]


def _fuzz(n: int = 100):
    rng = random.Random(5)
    pools = [
        lambda: chr(rng.randrange(0x20, 0x7F)),
        lambda: chr(rng.randrange(0xA0, 0x2FF)),
        lambda: chr(rng.randrange(0x4E00, 0x9FFF)),
        lambda: chr(rng.randrange(0x1F300, 0x1F64F)),
        lambda: rng.choice(" \t\n\r\x0b\x0c"),
        lambda: chr(rng.randrange(0x00, 0x20)),
    ]
    return ["".join(rng.choice(pools)() for _ in range(rng.randrange(1, 60))) for _ in range(n)]


def _reports():
    """The synthetic tree's sections, and prompts built from them."""
    out = list(FINDINGS) + list(IMPRESSION)
    out += [f"[PMT]{f}[PMT-SEP]{i}[BOS]" for f, i in zip(FINDINGS, IMPRESSION)]
    out += [f"{f}. {i}." for f in FINDINGS for i in IMPRESSION]
    return out


def _code(path) -> list:
    """A C++ source's lines without comments and blank lines."""
    lines = (line.split("//")[0].rstrip() for line in open(path, encoding="utf-8"))
    return [line for line in lines if line]


def test_native_encode_equals_python_and_jax(tmp_path, monkeypatch):
    """The port's binding and the JAX package's (``attach``), each over its
    own engine: the JAX package's ``bpe.cpp`` (the port's but for comments,
    checked) is compiled apart with its build.py's flags into this test's
    directory, since its own build would rewrite the package's library in
    place, racing a worker that loads it."""
    from cxrmate_tpu.tokenizer import ByteLevelBPETokenizer as JaxTokenizer
    from cxrmate_tpu.tokenizer.native import build as jax_build
    from cxrmate_tpu.tokenizer.native_binding import attach as jax_attach

    jax_source = os.path.join(jax_build.HERE, "bpe.cpp")
    assert _code(nb.SOURCE) == _code(jax_source)
    texts = HARD_CASES + _fuzz() + _reports()
    tok = ByteLevelBPETokenizer.from_file(TOKENIZER)
    python = [tok.encode(t) for t in texts]
    native = nb.attach(tok)
    assert tok._native is native
    assert [tok.encode(t) for t in texts] == python
    assert [native.encode(t) for t in texts] == python
    port_lib = nb.build()
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path)
    jax_lib = host_build.build_library("jax-bpe", jax_source, os.path.basename(jax_build.SO_PATH),
                                       ("-O2", "-shared", "-fPIC", "-std=c++17"),
                                       headers=(jax_build.TABLES,))
    assert jax_lib.parent.parent == tmp_path != port_lib.parent.parent
    monkeypatch.setattr(jax_build, "build", lambda force=False: str(jax_lib))
    jtok = JaxTokenizer.from_file(TOKENIZER)
    assert jax_attach(jtok) is not None
    assert [jtok.encode(t) for t in texts] == python


def test_bytes_outside_the_vocab_and_a_malformed_merge_table():
    """Model unk null: unknown bytes are dropped before merging; a merge
    whose output is missing from the vocab drops the symbol; with an unk
    token, unknown bytes map to it. The native encoder agrees each time."""
    specials = ["[UNK]", "[BOS]", "[EOS]", "[SEP]", "[PAD]", "[MASK]"]
    vocab = {t: i for i, t in enumerate(specials)}
    for ch in "abc":
        vocab[ch] = len(vocab)
    for merges, unk in (([("a", "b")], None), ([("a", "b")], "[UNK]")):
        tok = ByteLevelBPETokenizer(vocab, merges, unk_token=unk)
        texts = ("abc", "ab", "cab", "aabbc", "aXb", "aéc")
        python = [tok.encode(t) for t in texts]
        nb.attach(tok)
        assert [tok.encode(t) for t in texts] == python, unk


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "bpe.cpp"
    broken.write_text('#error "the engine does not compile"\n')
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(nb, "SOURCE", broken)
    monkeypatch.setattr(nb, "_lib", None)
    with pytest.raises(RuntimeError, match="the engine does not compile"):
        nb.attach(ByteLevelBPETokenizer.from_file(TOKENIZER))


def test_unicode_tables_equal_the_jax_packages():
    """The committed tables are the JAX package's, which its build.py
    generates from ``regex``'s classes; a seeded sample of code points is
    held to ``regex`` too (the full generation takes seconds)."""
    import bisect
    import re as _re

    jax_tables = os.path.join(REPO, "cxrmate_tpu", "tokenizer", "native", "unicode_tables.h")

    def digest(p):
        return hashlib.sha256(open(p, "rb").read()).hexdigest()

    assert digest(nb.TABLES) == digest(jax_tables)
    regex = pytest.importorskip("regex")
    text = nb.TABLES.read_text()
    classes = {"kLetterRanges": r"\p{L}", "kNumberRanges": r"\p{N}", "kSpaceRanges": r"\s"}
    rng = random.Random(3)
    sample = [rng.randrange(0x110000) for _ in range(3000)] + list(range(0x3000))
    sample = [cp for cp in sample if not 0xD800 <= cp <= 0xDFFF]
    for name, cls in classes.items():
        body = text.split(f"{name}[][2] = {{")[1].split("};")[0]
        ranges = [tuple(map(int, m)) for m in _re.findall(r"\{(\d+)u, (\d+)u\}", body)]
        starts = [a for a, _ in ranges]
        pat = regex.compile(cls)
        for cp in sample:
            k = bisect.bisect_right(starts, cp) - 1
            inside = k >= 0 and ranges[k][0] <= cp <= ranges[k][1]
            assert inside == (pat.match(chr(cp)) is not None), (name, hex(cp))
