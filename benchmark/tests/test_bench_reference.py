"""The reference against the port's CPU path at the tiny test sizes, the
control (the reference in float8) and the faults a served cell can have,
each seen by the comparison that decides ``correct``."""

import os

import pytest

from benchmark.faults import FAULTS
from benchmark.kinds import serve
from benchmark.tests.conftest import SERVED, limits, tiny_config, tiny_mix


def run(name, traffic, cell, seed=2 ** 31 + 11, seconds=0.0):
    r = serve.run(tiny_config(name), tiny_mix(traffic), limits(cell), seed, seconds, False, "cpu")
    return all(c["value"] <= c["limit"] for c in r["check"].values()), r


@pytest.mark.parametrize("name,traffic,cell", SERVED)
def test_port_agrees_with_the_reference(name, traffic, cell):
    ok, r = run(name, traffic, cell, seconds=2.0)  # several batches, one judged
    assert ok, r["check"]
    assert r["batches"] > 1 and r["failed"] == 0
    assert r["studies"] == 6 * r["batches"] and r["steps"] == 9 * r["batches"]


@pytest.mark.parametrize("name,traffic,cell", SERVED)
def test_control_fails(name, traffic, cell):
    """The reference computed in float8 in the program's place."""
    lim = limits(cell)
    for seed in (1, 2, 3):
        got = serve.readings(tiny_config(name), tiny_mix(traffic), seed, "cpu", q8=False)
        assert any(v > lim[k] for k, v in got["fp8"].items()), got


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name,traffic,cell", SERVED)
def test_faults_are_caught(fault, name, traffic, cell):
    with FAULTS[fault]():
        ok, r = run(name, traffic, cell)
    assert not ok, r["check"]


def test_a_prompt_altered_is_caught():
    """The program's prompt with [PMT-SEP] written as [SEP]: ``prompt_err``."""
    from cxrmate_torch.models import encoder_decoder as ed

    tokenize = ed.tokenize_prompt

    def broken(*a, **kw):
        out = tokenize(*a, **kw)
        tok = a[2]
        ids = out["input_ids"]
        ids[ids == tok.vocab["[PMT-SEP]"]] = tok.sep_token_id
        return out

    ed.tokenize_prompt = broken
    try:
        ok, r = run(*SERVED[0])
    finally:
        ed.tokenize_prompt = tokenize
    assert not ok and r["check"]["prompt_err"]["value"] > 0, r["check"]


@pytest.mark.cuda
def test_card_run(card, tmp_path):
    """One short run of each served cell on the card, end to end; and none
    in a directory that holds only the manifest and the benchmark."""
    import json
    import shutil
    import subprocess
    import sys

    from benchmark.tests.conftest import REPO

    def run_in(root, cell):
        return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                               "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                              cwd=root, capture_output=True, text=True, timeout=900)

    for _, _, cell in SERVED:
        out = run_in(REPO, cell)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = run_in(tmp_path, SERVED[0][2])
    assert out.returncode != 0 and not out.stdout.strip()
