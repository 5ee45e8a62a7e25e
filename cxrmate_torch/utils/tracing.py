"""Profiling and trace annotation: the port of ``cxrmate_tpu/utils/tracing.py``.

The host loops in ``cli/stages.py`` wrap their device work in
:func:`annotate` ("decode", "train_step"), a ``torch.profiler`` range that
also opens an NVTX range on the card, so both show in a profiler's trace.
:func:`profile` runs a ``torch.profiler`` session around a block; open one
only around what is to be traced, since a session slows every later launch
of its process. :class:`StepTimer` times steps on the host clock, fenced by
``torch.cuda.synchronize`` when the card is in use."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, record_function


class annotate(contextlib.ContextDecorator):
    """A named range for a profiler's trace (``torch.profiler``'s
    ``record_function``, plus an NVTX range when CUDA is available); usable
    as a context manager or a decorator. Without a profiler session it costs
    two small calls."""

    def __init__(self, name: str):
        self.name = name
        self._range = None
        self._nvtx = False

    def __enter__(self):
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


@contextlib.contextmanager
def profile(log_dir: str, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` session over the block (the host, and the card
    when CUDA is available), its Chrome trace written under ``log_dir``.
    Yields the session (``key_averages()`` for sums by kernel), or None when
    not ``enabled``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock step times; each ``measure`` ends with
    ``torch.cuda.synchronize`` when ``fence`` (the default) and the card is
    in use, so it counts the device's work and not only its launch."""

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def measure(self, fence: bool = True):
        t0 = time.perf_counter()
        yield
        if fence and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "min_s": float(arr.min()),
        }
