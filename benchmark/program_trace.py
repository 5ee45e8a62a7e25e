"""Readings of the program's own spans and counters
(``cxrmate_torch.utils.tracing``) in a served cell's traced run.

The readers take the first request recorded in the process: the batch that
``Cell.traced_batch`` serves under the device-only profiler, whose host pace
is nearly that of an untraced batch. The host-traced replay after it, slowed
by the tracing of the host's operators, is not read. Each reader returns
None where nothing was recorded, as with a program that has no such spans.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional


def first_request() -> Optional[List]:
    """The spans of the first request the program recorded, or None."""
    from cxrmate_torch.utils import tracing

    requests = getattr(tracing, "requests", None)
    got = requests() if requests is not None else []
    return got[0] if got else None


def _steps(spans):
    """(decode_step span, its stop_check spans) of each step."""
    checks = defaultdict(list)
    for s in spans:
        if s.name == "stop_check":
            checks[s.parent].append(s)
    return [(s, checks[s.id]) for s in spans if s.name == "decode_step"]


def _total(spans, name: str) -> int:
    return sum(s.counts.get(name, 0) for s in spans)


def decode_host_ms(spans) -> Optional[float]:
    """Decode loop: mean over the request's steps of ``decode_step`` less
    its ``stop_check``, the host's time issuing a step's work, in ms."""
    steps = _steps(spans)
    if not steps:
        return None
    host = [(s.t1 - s.t0) - sum(c.t1 - c.t0 for c in cs) for s, cs in steps]
    return sum(host) / len(host) * 1e-6


def decode_wait_ms(spans) -> Optional[float]:
    """Decode loop: mean ``stop_check`` a step, the host blocked on the
    card at the step's one read, in ms."""
    steps = _steps(spans)
    if not steps:
        return None
    return sum(c.t1 - c.t0 for _, cs in steps for c in cs) / len(steps) * 1e-6


def host_reads_per_step(spans) -> Optional[float]:
    """Decode loop: the request's ``host_read`` count (every copy from the
    card or wait for it, set-up and splitting included) over its
    ``decode_steps``."""
    steps = _total(spans, "decode_steps")
    return _total(spans, "host_read") / steps if steps else None


def encode_stream_ms_per_image(spans) -> Optional[float]:
    """Encode: ``encode``'s time on the card's stream (CUDA events, no sync
    around it) over the image slots it encoded (studies x slots), in ms."""
    encodes = [s for s in spans if s.name == "encode" and s.device_ms is not None]
    images = _total(encodes, "images")
    return sum(s.device_ms for s in encodes) / images if images else None


def reader(quantity):
    """A metric file's ``read(r)``: ``quantity`` of the first request."""
    def read(r=None):
        spans = first_request()
        return quantity(spans) if spans else None
    return read
