"""Training checkpoints: save a train state, pick one, resume from it.

The port of ``cxrmate_tpu/ckpt/orbax_io.py``, which stands in for the
reference's Lightning ModelCheckpoint (and the ``resume_from_ckpt_path`` /
best-checkpoint resolution of its ``tools/stages.py:52-112``). The layout on
disk is the JAX package's, so either package's selection functions read the
other's tree:

    <exp_dir_trial>/checkpoints/
        epoch=E[-step=S][-<monitor>=V]/   one per save (V with 6 decimals)
            state.pt                      the train state (torch.save)
            MARKER.json                   the trainer position
            <extra_files>
        last/                             the latest save, and EPOCH
        index.json                        tag -> {epoch, monitor, value}

``state.pt`` holds a ``train.tf_trainer.TrainState``: the model's state dict
(the fp32 masters and the BatchNorm buffers, ``num_batches_tracked``
included), AdamW's ``count``, ``mini_step``, ``mu``, ``nu`` and ``acc``, and
``step``. It is read back with ``torch.load(weights_only=True)``. A released
HF checkpoint directory is read by ``ckpt.hf.load_hf_pretrained_dir``
(the counterpart of ``orbax_io.py:315 load_torch_checkpoint``).

In a process group rank 0 writes the state, the marker, the index and
``last/``; every rank writes its own ``extra_files``. Under tensor
parallelism each split tensor (and AdamW's state of it) is gathered over the
model group first (``parallel.mesh.shard_dim``), so ``state.pt`` is the
one a one-process run writes, and it resumes at any layout: a restore loads
it whole and cuts this rank's shard (``ckpt.hf.shard_state_dict``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import torch

from cxrmate_torch.ckpt.hf import shard_state_dict
from cxrmate_torch.parallel.mesh import model_shard, shard_dim
from cxrmate_torch.utils import dist

STATE_FILE = "state.pt"


def _ckpt_dir(exp_dir_trial: str, tag: str) -> str:
    return os.path.join(exp_dir_trial, "checkpoints", tag)


def gather_shards(sd: Dict, model) -> Dict:
    """``sd`` (a model state dict, or AdamW state by parameter name) whole:
    each tensor split over the model group gathered along its dimension
    (every rank of the group calls this, in the same key order)."""
    tp = model_shard(model)
    if tp is None:
        return sd
    out = {}
    for k, v in sd.items():
        dim = shard_dim(k, model.config.decoder, tp.size)
        out[k] = v if dim is None else torch.cat(dist.all_gather_tensor(v, tp.group), dim=dim)
    return out


def _state_dict(state) -> Dict:
    opt = state.opt_state
    return {"model": gather_shards(state.model.state_dict(), state.model),
            "step": int(state.step),
            "opt_state": {"count": int(opt.count), "mini_step": int(opt.mini_step),
                          **{k: gather_shards(getattr(opt, k), state.model)
                             for k in ("mu", "nu", "acc")}}}


def _local(sd: Dict, model) -> Dict:
    """A whole state dict (or AdamW state) cut to ``model``'s shard; as it
    is for a whole model."""
    tp = model_shard(model)
    if tp is None:
        return sd
    return shard_state_dict(sd, tp.rank, tp.size, model.config.decoder)


def save_checkpoint(
    exp_dir_trial: str,
    state,
    epoch: int,
    monitor_value: Optional[float] = None,
    monitor: str = "val_report_chexbert_f1_macro",
    keep_top_k: int = 1,
    mode: str = "max",
    step: Optional[int] = None,
    n_batches: Optional[int] = None,
    global_step: Optional[int] = None,
    extra_files: Optional[Dict[str, str]] = None,
    mbatch_size: Optional[int] = None,
    world_size: Optional[int] = None,
    global_schedule: bool = False,
) -> str:
    """Save ``state`` (a ``TrainState``) for ``epoch``; prune to the top k by
    the monitored metric. ``step`` tags mid-epoch saves (Lightning's
    ``epoch=0-step=1567`` naming, produced by ``val_check_interval`` < 1).

    Every checkpoint carries a ``MARKER.json`` with the trainer position
    (epoch, global step, in-epoch batch count, the loader schedule), so that a
    mid-epoch save resumes inside its epoch. ``extra_files`` (name -> text)
    are written beside it. -> the checkpoint's directory."""
    tag = f"epoch={epoch}"
    if step is not None:
        tag += f"-step={step}"
    if monitor_value is not None:
        tag += f"-{monitor}={monitor_value:.6f}"
    path = os.path.abspath(_ckpt_dir(exp_dir_trial, tag))
    marker = {"epoch": epoch, "step": step, "n_batches": n_batches,
              "global_step": global_step if global_step is not None else step,
              # the loader schedule the in-epoch position is measured in;
              # global_schedule marks positions counted in global batches
              "mbatch_size": mbatch_size, "world_size": world_size,
              "global_schedule": global_schedule}
    rank0 = dist.rank() == 0
    blob = _state_dict(state)  # every rank: the gathers are collectives

    def write(ckpt_path: str) -> None:
        if rank0:
            with open(os.path.join(ckpt_path, "MARKER.json"), "w") as f:
                json.dump(marker, f)
        for name, content in (extra_files or {}).items():
            with open(os.path.join(ckpt_path, name), "w") as f:
                f.write(content)

    if rank0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(blob, os.path.join(path, STATE_FILE))
    dist.barrier()  # the directory exists before any rank writes into it
    write(path)
    # every rank's sidecar lands before rank 0 prunes (a save can be its own victim)
    dist.barrier()
    last_path = _ckpt_dir(exp_dir_trial, "last")
    if rank0:
        # a Lightning-style "last" checkpoint for resume_last, copied before
        # the pruning below may remove this save
        if os.path.exists(last_path):
            shutil.rmtree(last_path)
        os.makedirs(last_path)
        shutil.copyfile(os.path.join(path, STATE_FILE), os.path.join(last_path, STATE_FILE))
        with open(os.path.join(last_path, "EPOCH"), "w") as f:
            f.write(str(epoch))
        index_path = os.path.join(exp_dir_trial, "checkpoints", "index.json")
        index = {}
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
        index[tag] = {"epoch": epoch, "monitor": monitor, "value": monitor_value}
        if monitor_value is not None and keep_top_k > 0:
            scored = [(k, v) for k, v in index.items() if v.get("value") is not None]
            scored.sort(key=lambda kv: kv[1]["value"], reverse=mode == "max")
            for k, _ in scored[keep_top_k:]:
                victim = _ckpt_dir(exp_dir_trial, k)
                if os.path.exists(victim):
                    shutil.rmtree(victim)
                index.pop(k, None)
        with open(index_path, "w") as f:
            json.dump(index, f, indent=1)
    dist.barrier()
    write(last_path)
    return path


def restore_checkpoint(path: str, state):
    """Load a checkpoint's train state into ``state`` (a ``TrainState`` built
    for the same model and optimizer, e.g. a fresh ``create_train_state``), on
    that state's device, in place; -> ``state``. Every tensor must be there
    with its shape: the model strictly, the moments and ``acc`` key for key.
    A model cut to a model rank's shard takes its shard of each."""
    device = next(state.model.parameters()).device
    blob = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.model.load_state_dict(_local(blob["model"], state.model), strict=True)
    opt, saved = state.opt_state, blob["opt_state"]
    for name in ("mu", "nu", "acc"):
        have, got = getattr(opt, name), _local(saved[name], state.model)
        if set(have) != set(got):
            raise KeyError(f"{path}: {name} holds {sorted(set(have) ^ set(got))[:4]} "
                           "that the train state does not, or the other way round")
        with torch.no_grad():
            for k, v in got.items():
                have[k].copy_(v)
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    state.step = blob["step"]
    return state


def restore_model(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load only a checkpoint's model weights into ``model`` (e.g. a
    ``CXRMate.model`` to decode with), strictly, cast to the model's dtypes
    on its device (a model rank's shard of them where ``model`` is cut to
    one); -> ``model``."""
    device = next(model.parameters()).device
    blob = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    model.load_state_dict(_local(blob["model"], model), strict=True)
    return model


def best_checkpoint(exp_dir_trial: str, mode: str = "max") -> Optional[str]:
    """The best checkpoint by the monitored metric (``index.json``); without
    scored entries the one of the latest epoch."""
    index_path = os.path.join(exp_dir_trial, "checkpoints", "index.json")
    if not os.path.exists(index_path):
        return None
    with open(index_path) as f:
        index = json.load(f)
    scored = [(k, v) for k, v in index.items() if v.get("value") is not None]
    if not scored:
        scored = list(index.items())
        if not scored:
            return None
        tag = max(scored, key=lambda kv: kv[1]["epoch"])[0]
        return _ckpt_dir(exp_dir_trial, tag)
    pick = (max if mode == "max" else min)(scored, key=lambda kv: kv[1]["value"])
    return _ckpt_dir(exp_dir_trial, pick[0])


def last_checkpoint(exp_dir_trial: str) -> Optional[str]:
    """The most recent checkpoint: the dedicated 'last' save if present, else the
    newest indexed one."""
    last_path = _ckpt_dir(exp_dir_trial, "last")
    if os.path.exists(last_path):
        return last_path
    index_path = os.path.join(exp_dir_trial, "checkpoints", "index.json")
    if not os.path.exists(index_path):
        return None
    with open(index_path) as f:
        index = json.load(f)
    if not index:
        return None
    tag = max(index.items(), key=lambda kv: kv[1]["epoch"])[0]
    return _ckpt_dir(exp_dir_trial, tag)


def checkpoint_for_epoch(exp_dir_trial: str, epoch: int) -> Optional[str]:
    """The checkpoint saved for ``epoch`` (dlhpcstarter's
    ``resume_epoch``/``test_epoch``: ``epoch=N-...`` by number). Of several
    saves in one epoch the latest by step number; the epoch-end save carries
    no step and wins, and equal steps go to the most recent save."""
    ckpt_root = os.path.join(exp_dir_trial, "checkpoints")
    if not os.path.isdir(ckpt_root):
        return None

    def sort_key(tag: str):
        m = re.search(r"step=(\d+)", tag)
        step = int(m.group(1)) if m else float("inf")
        return (step, os.path.getmtime(_ckpt_dir(exp_dir_trial, tag)))

    best = None
    for tag in sorted(os.listdir(ckpt_root)):
        m = re.match(r"epoch=(\d+)(-|$)", tag)
        if m and int(m.group(1)) == epoch:
            if best is None or sort_key(tag) > sort_key(best):
                best = tag
    return _ckpt_dir(exp_dir_trial, best) if best else None


def resolve_resume(
    exp_dir_trial: str,
    resume_last: bool = False,
    resume_epoch: Optional[int] = None,
    resume_ckpt_path: Optional[str] = None,
) -> Optional[str]:
    """dlhpcstarter ``resume_from_ckpt_path`` (reference ``tools/stages.py:88``):
    an explicit path, else a given epoch's, else the latest."""
    if resume_ckpt_path:
        if not os.path.exists(resume_ckpt_path):
            raise FileNotFoundError(f"resume_ckpt_path not found: {resume_ckpt_path}")
        return resume_ckpt_path
    if resume_epoch is not None:
        path = checkpoint_for_epoch(exp_dir_trial, resume_epoch)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for resume_epoch={resume_epoch} under {exp_dir_trial}")
        return path
    if resume_last:
        return last_checkpoint(exp_dir_trial)
    return None


def get_test_ckpt_path(
    exp_dir_trial: str,
    monitor_mode: str = "max",
    test_epoch: Optional[int] = None,
    test_ckpt_path: Optional[str] = None,
) -> Optional[str]:
    """dlhpcstarter ``get_test_ckpt_path`` (reference ``tools/stages.py:103-105``,
    and the warm start from another experiment at :66-72): an explicit path,
    else a given epoch's, else the best by the monitor."""
    if test_ckpt_path:
        if not os.path.exists(test_ckpt_path):
            raise FileNotFoundError(f"test_ckpt_path not found: {test_ckpt_path}")
        return test_ckpt_path
    if test_epoch is not None:
        path = checkpoint_for_epoch(exp_dir_trial, test_epoch)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint for test_epoch={test_epoch} under {exp_dir_trial}")
        return path
    return best_checkpoint(exp_dir_trial, monitor_mode)


def checkpoint_resume_info(path: str) -> Dict[str, Optional[int]]:
    """Trainer position of a checkpoint: ``{'epoch', 'step', 'n_batches',
    'global_step', 'mbatch_size', 'world_size', 'global_schedule'}`` from its
    ``MARKER.json``; a checkpoint without one falls back to its tag
    (``epoch=E[-step=S]``) with the other fields unknown."""
    marker_path = os.path.join(path, "MARKER.json")
    if os.path.exists(marker_path):
        with open(marker_path) as f:
            info = json.load(f)
        return {k: info.get(k) for k in (
            "epoch", "step", "n_batches", "global_step", "mbatch_size", "world_size",
            "global_schedule")}
    base = os.path.basename(os.path.normpath(path))
    e = re.search(r"epoch=(\d+)", base)
    s = re.search(r"step=(\d+)", base)
    return {
        "epoch": int(e.group(1)) if e else None,
        "step": int(s.group(1)) if s else None,
        "n_batches": None,
        "global_step": int(s.group(1)) if s else None,
        "mbatch_size": None,
        "world_size": None,
        "global_schedule": False,
    }


def checkpoint_extra_file(path: str, name: str) -> Optional[str]:
    """An ``extra_files`` sidecar written by :func:`save_checkpoint`; None
    when absent."""
    p = os.path.join(path, name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return f.read()


def checkpoint_epoch_from_path(path: str) -> Optional[int]:
    """The epoch number in a checkpoint directory's name."""
    m = re.search(r"epoch=(\d+)", os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else None


def last_checkpoint_epoch(exp_dir_trial: str) -> Optional[int]:
    marker = os.path.join(_ckpt_dir(exp_dir_trial, "last"), "EPOCH")
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    return None
