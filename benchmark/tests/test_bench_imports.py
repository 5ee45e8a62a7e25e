"""What the benchmark's processes load: never JAX or the JAX package, and
for the reference nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.conftest import REPO

PROBE = ("import sys, {mods}; "
         "print(sorted({{m.split('.')[0] for m in sys.modules}}))")


def loaded(*modules) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=", ".join(modules))],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": REPO})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_process_loads_no_jax():
    names = loaded("benchmark.run", "benchmark.kinds.serve", "benchmark.control",
                   "cxrmate_torch.models.api", "cxrmate_torch.ckpt.hf")
    assert "cxrmate_torch" in names
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = loaded("benchmark.reference.model", "benchmark.reference.judge",
                   "benchmark.reference.prompt")
    assert not names & {"cxrmate_torch", *FORBIDDEN}


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(REPO, "benchmark", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                            else [node.module or ""])
                    for m in mods:
                        assert m.split(".")[0] in (
                            "torch", "benchmark", "__future__", "math", "contextlib", "typing",
                            "functools", "json", "os", "re", "unicodedata"), (name, m)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cxrmate_tpu_like", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cxrmate_tpu.ops", object())
    assert forbidden_modules() == ["cxrmate_tpu"]
