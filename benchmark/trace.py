"""Reading a traced window: the device's kernels from ``torch.profiler``,
and the benchmark's own host ranges (``record_function`` around the calls it
wraps), which name what the host was doing while the device idled."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

RANGE = "bench:"  # prefix of the benchmark's record_function ranges
TOP = 10


@contextlib.contextmanager
def traced(summary: dict, host: bool = False):
    """Profile the block; on exit fill ``summary`` with ``kernels`` {name:
    device seconds}, ``launches`` {name: count}, ``busy_s`` (the union of
    device activity), ``window_s`` (the block's length on the host clock,
    synchronised on both sides), ``device_ops`` and, with ``host``,
    ``gaps``: the idle time between device activity by the benchmark's
    range that the host was in. Without ``host`` only the device is traced
    (CUPTI's activity records), which leaves the host's pace nearly as it
    is untraced; tracing the host's operators too slows the host's
    dispatch, and with it any batch that the host paces, so a block traced
    with ``host`` names the gaps and times nothing."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    summary.update(read_events(prof.profiler.kineto_results.events()), window_s=window_s)


def named_gaps(gaps: List[List], idle_s: float) -> List[List]:
    """The gaps of a block traced with ``host``, each range's share of their
    sum put on ``idle_s``, the idle time of the block traced without it."""
    total = sum(v for _, v in gaps)
    return [[k, v / total * idle_s] for k, v in gaps] if total > 0 else []


def _is_device(e) -> bool:
    return (str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
            and not e.name().startswith(RANGE) and e.duration_ns() > 0)


def read_events(events) -> dict:
    kernels: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    spans: List[Tuple[int, int]] = []
    ranges: List[Tuple[int, int, str]] = []
    for e in events:
        if _is_device(e):
            kernels[e.name()] += e.duration_ns() * 1e-9
            launches[e.name()] += 1
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name().startswith(RANGE) and str(e.device_type()).endswith("CPU"):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(RANGE):]))
    spans.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    idle = _name_gaps(gaps, ranges)
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernels": dict(kernels), "launches": dict(launches), "busy_s": busy * 1e-9,
            "device_ops": [[k, v] for k, v in ops], "gaps": [[k, v] for k, v in idle]}


def _name_gaps(gaps, ranges) -> List[Tuple[str, float]]:
    """Idle time between device activity, summed by the innermost benchmark
    range the host was in at each gap's middle ("outside" where none)."""
    ranges.sort(key=lambda r: (r[0], -r[1]))  # nested: an outer range first
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "outside"] += (g1 - g0) * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])
