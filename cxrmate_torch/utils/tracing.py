"""Spans and counters of the program, on the profiler's clock.

Outside a ``torch.profiler`` session, :func:`span` returns a shared no-op
and :func:`count` returns at once: one check of the flag that every session
sets (CPU or CUDA only alike) is all they cost. Inside a session each span
records ``(request, id, parent, name, t0, t1)`` in memory, stamped with
``time.time_ns()``, the epoch clock the profiler stamps its events with, and
opens ``record_function("cxr." + name)``, so it also stands in the
profiler's timeline beside the kernels. A span opened while none is open is
the root of a new request (``CXRMate.generate_report`` is one: a batch of
studies); every span under it carries the request's id. :func:`count` adds
to the innermost open span. :func:`requests` returns the last :data:`KEEP`
requests; nothing is written to disk unless :func:`profile` asks.

:func:`profile` is the operator's exporter: a session over a block, its
Chrome trace, and ``idle_by_span``, the device's idle gaps in the block put
down to the program's spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, record_function

KEEP = 8  # finished requests kept in memory
PREFIX = "cxr."  # of the spans' ranges in the profiler's timeline


@dataclasses.dataclass
class Span:
    """One span of a request. ``t0``/``t1``: ``time.time_ns()`` at its open
    and close; ``counts``: what :func:`count` added while it was the
    innermost open span; ``device_ms``: its time on its device's stream
    (CUDA events), where the span was opened with a CUDA ``device``."""

    request: int
    id: int
    parent: Optional[int]
    name: str
    t0: int
    t1: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = dataclasses.field(
        default=None, repr=False)


_done: collections.deque = collections.deque(maxlen=KEEP)  # finished requests, oldest first
_local = threading.local()  # this thread's open spans (``stack``) and its request's (``spans``)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Open:
    """An open span: its record, its profiler range, and its CUDA events."""

    __slots__ = ("name", "device", "span", "range")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if not stack:
            stack = _local.stack = []
            _local.spans = []
            request, parent = next(_request_ids), None
        else:
            request, parent = stack[-1].request, stack[-1].id
        self.range = record_function(PREFIX + self.name)
        self.range.__enter__()
        self.span = Span(request, next(_span_ids), parent, self.name, time.time_ns())
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.span.events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
            self.span.events[0].record()
        _local.spans.append(self.span)
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        if self.span.events is not None:
            self.span.events[1].record()
        self.span.t1 = time.time_ns()
        self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if not stack:
            _done.append(_local.spans)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None):
    """A span named ``name`` around a block (``with span("encode"):``).
    ``device``: where the block's work runs; a CUDA device also times the
    span on its current stream with two CUDA events, read by
    :func:`requests` (no host sync is added)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def requests() -> List[List[Span]]:
    """The last :data:`KEEP` finished requests, oldest first, each its spans
    in the order they opened (the root first), with each span's
    ``device_ms`` read from its CUDA events."""
    out = list(_done)
    for spans in out:
        for s in spans:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
    return out


def device_intervals(events) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of each kernel, copy and set on the card among a
    session's events (``prof.profiler.kineto_results.events()``)."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
            and not e.name().startswith(PREFIX) and e.duration_ns() > 0]


def idle_by_span(device: Sequence[Tuple[int, int]], spans: Sequence[Span]) -> Dict[str, float]:
    """Seconds the device sat idle between its activities (``device``:
    (start_ns, end_ns) pairs, on the spans' clock), each gap put down to the
    innermost span open at the gap's middle ("outside" where none), largest
    first."""
    gaps, end = [], None
    for s, e in sorted(device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    ranges = sorted(((s.t0, s.t1, s.name) for s in spans), key=lambda r: (r[0], -r[1]))
    out: Dict[str, float] = collections.defaultdict(float)
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
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


@dataclasses.dataclass
class Trace:
    """What :func:`profile` yields: the ``torch.profiler`` session
    (``key_averages()`` for sums by kernel) and, once the block has ended,
    ``idle_by_span``."""

    session: torch.profiler.profile
    idle_by_span: Dict[str, float] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[Trace]:
    """A ``torch.profiler`` session over the block (the host, and the card
    when CUDA is available). On exit it writes the Chrome trace
    (``trace_<pid>.json``) and ``idle_by_span_<pid>.json`` under
    ``log_dir``: the device's idle gaps inside the block, each put down to
    the innermost span, of the requests that ended in the block, open at
    the gap's middle. Open it only around what is to be traced: a session
    slows every later launch of its process."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as session:
        out = Trace(session)
        yield out
    spans = [s for spans in requests() for s in spans if s.t0 >= t0]
    out.idle_by_span = idle_by_span(device_intervals(session.profiler.kineto_results.events()),
                                    spans)
    session.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
    with open(os.path.join(log_dir, f"idle_by_span_{os.getpid()}.json"), "w") as f:
        json.dump(out.idle_by_span, f, indent=1)
