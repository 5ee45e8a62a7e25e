"""Process-group initialisation: the port's counterpart of
``cxrmate_tpu/parallel/multihost.py``.

The reference trains DDP over NCCL processes; so does the port, with the
gradient reduction written out (``train.tf_trainer``, ``train.scst``) and
host-side gathers in ``eval/metrics.py``. The launcher is ``torchrun`` (or
``python -m torch.distributed.run``), which exports ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`launch_ranks` runs it from Python with a time limit."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from cxrmate_torch.utils import dist as dist_utils


def backend_for(device: str = "cuda") -> str:
    """``nccl`` when every rank of this host has a card of its own, ``gloo``
    on the CPU or when ranks share a card (NCCL refuses two ranks on one
    device). Read from the environment: ``LOCAL_WORLD_SIZE`` ranks on this
    host."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize_if_needed(device: str = "cuda") -> bool:
    """Join the process group when the launcher started more than one
    process, or a group of one (``WORLD_SIZE`` set); a no-op otherwise.

    The decision is taken from the environment alone: without ``WORLD_SIZE``
    this returns False and touches nothing. Idempotent by state: a process
    that is already in a group returns False. Any failure (no
    ``MASTER_ADDR``, an unreachable rendezvous) propagates: swallowing it
    would run every process as its own one-process job, each training alone
    and writing the same checkpoints. On the card the rank's device is
    ``cuda:{LOCAL_RANK % device_count}``, made current before the group
    starts. Returns True iff this call initialised the group."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist_utils.initialized():
        return False
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend=backend_for(device), init_method="env://")
    return True


def is_main_process() -> bool:
    return dist_utils.rank() == 0


def global_max_int(value: int) -> int:
    """Max of a host-side int across processes (the identity in one
    process). Where ranks must agree on a data-dependent width, e.g. the
    global batch's longest prompt, so that every rank's stripe tokenizes to
    the width the one-process run would use."""
    return dist_utils.all_reduce_max(value)


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(nproc: int, args: Sequence[str], timeout: float,
                 env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> str:
    """Run ``args`` (a script and its arguments, or ``-m module ...``) as
    ``nproc`` ranks of one process group on this host, through ``python -m
    torch.distributed.run``, which stops every rank when one fails. The
    launch runs in a session of its own: past ``timeout`` seconds (a hung
    rank, or a collective that never completes) all its processes are
    killed. -> the launch's output (stdout and stderr, every rank's);
    ``RuntimeError`` when a rank failed or the launch timed out."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "localhost",
           "--master_port", str(free_port())] + list(args)
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        # the launcher starts each rank in a session of its own: SIGTERM
        # makes it stop them; whatever is left a minute later is killed
        # (before reading on: a live rank holds the output pipe open)
        ranks = _descendants(proc.pid)
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for pid in ranks:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:  # already gone
                    pass
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        raise RuntimeError(f"{nproc} ranks of {list(args)[:3]} hung past {timeout} s:\n"
                           f"{out[-6000:]}") from None
    if proc.returncode:
        raise RuntimeError(f"{nproc} ranks of {list(args)[:3]} exited {proc.returncode}:\n"
                           f"{out[-6000:]}")
    return out


def _descendants(pid: int) -> list:
    """The processes below ``pid`` (Linux's ``/proc/PID/task/*/children``;
    none where that is not readable)."""
    found, todo = [], [pid]
    while todo:
        parent = todo.pop()
        try:
            tasks = os.listdir(f"/proc/{parent}/task")
        except OSError:
            continue
        for tid in tasks:
            try:
                with open(f"/proc/{parent}/task/{tid}/children") as f:
                    kids = [int(k) for k in f.read().split()]
            except OSError:
                continue
            found += kids
            todo += kids
    return found
