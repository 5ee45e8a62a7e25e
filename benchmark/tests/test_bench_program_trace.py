"""The readers of the program's spans and counters (``program_trace.py``)
on a fixed synthetic record: each reads the first request, not the
host-traced one after it, and gives None where nothing was recorded."""

from types import SimpleNamespace

import pytest

from benchmark import program_trace
from benchmark.manifest import Bench

NAMES = ["decode_host_ms", "decode_wait_ms", "host_reads_per_step",
         "encode_stream_ms_per_image"]


def span(id_, parent, name, t0, t1, counts=None, device_ms=None):
    return SimpleNamespace(request=1, id=id_, parent=parent, name=name, t0=t0, t1=t1,
                           counts=counts or {}, device_ms=device_ms)


def request(scale=1):
    """A request of two decode steps (ns stamps): step 1 issues for 3 ms and
    waits 1 ms, step 2 issues for 5 ms and waits 3 ms; 8 host reads in all;
    10 image slots encoded in 4 ms on the card."""
    ms = 1_000_000 * scale
    return [
        span(1, None, "generate_report", 0, 40 * ms, {"host_read": 1}),
        span(2, 1, "encode", 0, 2 * ms, {"images": 10}, device_ms=4.0 * scale),
        span(3, 1, "prefill", 2 * ms, 3 * ms, {"host_read": 3}),
        span(4, 1, "stop_check", 3 * ms, 4 * ms, {"host_read": 1}),
        span(5, 1, "decode_step", 10 * ms, 14 * ms, {"decode_steps": 1}),
        span(6, 5, "bert_step", 10 * ms, 12 * ms),
        span(7, 5, "stop_check", 13 * ms, 14 * ms, {"host_read": 1}),
        span(8, 1, "decode_step", 20 * ms, 28 * ms, {"decode_steps": 1}),
        span(9, 8, "stop_check", 25 * ms, 28 * ms, {"host_read": 1}),
        span(10, 1, "split_and_decode", 30 * ms, 31 * ms, {"host_read": 1}),
    ]


WANT = {"decode_host_ms": 4.0, "decode_wait_ms": 2.0, "host_reads_per_step": 4.0,
        "encode_stream_ms_per_image": 0.4}


@pytest.fixture
def recorded(monkeypatch):
    from cxrmate_torch.utils import tracing

    def use(requests):
        monkeypatch.setattr(tracing, "requests", lambda: requests)
    return use


@pytest.mark.parametrize("cell", ["beam", "greedy"])
@pytest.mark.parametrize("name", NAMES)
def test_reads_the_first_request(recorded, name, cell):
    read = Bench().reader(f"{name}.{cell}")
    recorded([request(), request(scale=3)])  # the host-traced replay, slower, second
    assert read({}) == pytest.approx(WANT[name])
    recorded([request(scale=3)])
    assert read({}) == pytest.approx(WANT[name] * (3 if name != "host_reads_per_step" else 1))


@pytest.mark.parametrize("name", NAMES)
def test_none_when_nothing_was_recorded(recorded, monkeypatch, name):
    read = Bench().reader(f"{name}.beam")
    recorded([])
    assert read({}) is None
    recorded([[span(1, None, "decode", 0, 5)]])  # a request without those spans
    assert read({}) is None
    from cxrmate_torch.utils import tracing

    monkeypatch.delattr(tracing, "requests")  # a program without the span API
    assert read({}) is None
    assert getattr(program_trace, name)([]) is None
