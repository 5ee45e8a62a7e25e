"""How far two ranks' fp32 SCST update lies from one process's, with cuDNN's
TF32 on and off, on the card.

    python3 -m cxrmate_torch.tools.mp_tf32    # from a checkout; one NVIDIA GPU

Builds ``chip_smoke.py``'s seeded checkpoints and its ``cli`` phase's tree,
then runs ``chip_smoke.py``'s fp32 SCST pair (``MP_SCST``: fast_dev_run, 2
studies; one process here, then 2 gloo ranks on the one card) under
``torch.backends.cudnn.allow_tf32`` on (PyTorch's default) and off, each
run twice. Per setting, one JSON line: the logged ``scst_loss``, ``reward``
and ``baseline`` of every run, and the relative L2 distance of AdamW's first
moments (the accumulated gradient) between the runs, over the decoder and
over its cross-attention, embedding, head and other tensors: between the two
runs of one process and of two ranks (run to run), and between two ranks and
one process.
"""

from __future__ import annotations

import json
import os
import shutil
import sys


def groups(key: str) -> str:
    if "crossattention" in key:
        return "cross_attention"
    if "embeddings" in key:
        return "embeddings"
    return "head" if key.startswith("decoder.cls.") else "other"


def distances(np, got, want) -> dict:
    """The relative L2 distance over all tensors and over each group."""
    sums = {}
    for k, y in want.items():
        for g in ("all", groups(k)):
            d, n = sums.get(g, (0.0, 0.0))
            sums[g] = (d + float(np.square(got[k] - y).sum()), n + float(np.square(y).sum()))
    return {g: float(np.sqrt(d / max(n, 1e-300))) for g, (d, n) in sums.items()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mp_tf32 needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.cli import config as cli_config
    from cxrmate_torch.models import api
    from cxrmate_torch.ops import _build

    repo = _build._PKG.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    _build.build()
    tok = os.path.join(cs.REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
    try:
        ckpts = {v: cs.write_checkpoint(torch, api, tok, v) for v in ("multi", "longitudinal")}
        _, tree = cs.cli_phase(torch, np, ckpts)
        root = os.path.join(cs.SMOKE_DIR, "mp_tf32")
        common = [f"{k}={v}" for k, v in tree.items()]

        def argv(name):
            return (["--train", "--config", os.path.join(
                cs.REPO, "config", "train", "longitudinal_gen_prompt_cxr-bert.yaml")]
                + cs.MP_SCST + common + [f"exp_dir={os.path.join(root, name)}"])

        def run(name, ranks, tf32):
            if ranks:
                cs.run_ranks(ranks, argv(name), os.path.join(root, "ranks_" + name), tf32)
            else:
                cs.run_in_process(torch, argv(name), tf32)
            trial = cli_config.parse_args(argv(name)).exp_dir_trial
            state = torch.load(os.path.join(ck.last_checkpoint(trial), ck.STATE_FILE),
                               map_location="cpu", weights_only=True)
            logs = {k: cs.train_losses(trial, (k,)) for k in ("scst_loss", "reward", "baseline")}
            return logs, {k: m.double().numpy() for k, m in state["opt_state"]["mu"].items()}

        for tf32 in (True, False):
            tag = "on" if tf32 else "off"
            one = [run(f"one_{tag}_{i}", 0, tf32) for i in range(2)]
            two = [run(f"two_{tag}_{i}", 2, tf32) for i in range(2)]
            print(json.dumps({
                "cudnn_tf32": tf32,
                "logs": {"one_process": [r[0] for r in one], "two_ranks": [r[0] for r in two]},
                "first_moments_rel_l2": {
                    "one_process_run_to_run": distances(np, one[1][1], one[0][1]),
                    "two_ranks_run_to_run": distances(np, two[1][1], two[0][1]),
                    "two_ranks_vs_one_process": distances(np, two[0][1], one[0][1])}}),
                flush=True)
    finally:
        shutil.rmtree(cs.SMOKE_DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
