"""The readings of a served cell's metrics, one function a quantity. Each
metric file under ``benchmark/metrics/`` takes one of them as its ``read``:
the beam and greedy cells report the same quantities under names of their
own, since each moves its own end-to-end rate."""

from benchmark.peaks import PEAK_FLOPS, bound_s
from benchmark.work import beam_reorder, decode_attention

DTYPES = {"bfloat16": "bf16", "float32": "fp32"}


def studies_per_s(r):
    """Reports delivered per second: every study the window completed over
    the window's whole length (host clock, batch boundaries)."""
    return r["studies"] / r["window_s"] if r.get("kind") == "serve" else None


def encode_ms_per_image(r):
    """Encode (``models/encoder_decoder.py:encode_images`` ->
    ``models/cvt.py``): milliseconds an image slot, over every encode call
    of the traced run's window, each timed on the synchronised host clock;
    every slot of a batch is encoded, padding included."""
    images = r["studies"] * r["slots"]
    return r["encode_s"] / images * 1e3 if r.get("kind") == "serve" and images else None


def decode_step_ms(r):
    """Decode loop (``generate/beam.py:beam_search``,
    ``generate/decode.py:generate`` -> ``models/bert.py:bert_step``): each
    batch's time outside its encode (the prefill, the steps, splitting and
    decoding the reports) over its decode steps, all batches of the traced
    run's window."""
    if not r.get("kind") == "serve" or not r["steps"]:
        return None
    return (r["batch_s"] - r["encode_s"]) / r["steps"] * 1e3


def _kernel_s(t, names):
    return sum(s for name, s in t["kernels"].items() if any(k in name for k in names))


def decode_attention_roofline(r):
    """Kernels, ``ops/decode_attention.py``: the least time the traced
    batch's decode-attention calls need (``work/decode_attention.py``, bytes
    of the keys that the masks let through, at the card's peaks) over the
    device time of their kernels, in percent."""
    t = r.get("trace")
    if not t:
        return None
    device_s, w = _kernel_s(t, decode_attention.KERNEL_NAMES), t["work"]
    if device_s <= 0 or w["attention_bytes"] <= 0:
        return None
    least, _ = bound_s(w["attention_bytes"], w["attention_flops"], DTYPES[r["dtype"]])
    return least / device_s * 100


def beam_reorder_roofline(r):
    """Kernels, ``ops/beam_reorder.py``: the least time the traced batch's
    beam reorders need (``work/beam_reorder.py``, bytes at the card's memory
    rate) over the device time of their kernels, in percent."""
    t = r.get("trace")
    if not t:
        return None
    device_s = _kernel_s(t, beam_reorder.KERNEL_NAMES)
    if device_s <= 0 or t["work"]["reorder_bytes"] <= 0:
        return None
    return bound_s(t["work"]["reorder_bytes"], 0.0, "bf16")[0] / device_s * 100


def mfu(r):
    """Whole step: the model operations of the window's batches
    (``work/model.py``) over the window's length and the card's bf16 peak
    (989 TFLOP/s, H100 SXM), in percent. The card's power limit is in the
    result line's ``card``."""
    if not r.get("kind") == "serve" or "flops" not in r:
        return None
    return r["flops"] / r["window_s"] / PEAK_FLOPS["bf16"] * 100


def device_idle_share(r):
    """Device: the share of the batch traced on the device alone (host
    clock, synchronised) in which no kernel or copy ran on the card, from
    ``torch.profiler``'s CUDA records, in percent."""
    t = r.get("trace")
    if not t or not r.get("kind") == "serve" or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
