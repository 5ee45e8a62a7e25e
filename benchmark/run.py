"""Run one cell of the benchmark of cxrmate_torch and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number compared
with its limit, which are also the last lines of standard error. No result
is printed, and the exit code is not 0, without the cards the cell asks
for, or when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# transformers (where installed) loads JAX and flax without this
os.environ.setdefault("USE_FLAX", "0")
FORBIDDEN = ("jax", "jaxlib", "flax", "cxrmate_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``cxrmate_torch`` begins with ``cxrmate_t``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def result_line(bench, cell: dict, r: dict, trace_on: bool, device: dict) -> dict:
    metrics = {}
    for m in (bench.per_layer if trace_on else bench.end_to_end)(cell["name"]):
        value = bench.reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c["value"] <= c["limit"] for c in r["check"].values()),
            "attempted": r["studies"], "failed": r["failed"], "metrics": metrics,
            "device": device}
    if trace_on:
        line["breakdown"] = r["trace"]["breakdown"]
    line["card"] = power_limit()
    line["window"] = {"batches": r["batches"], "steps_and_seconds": r["per_batch"],
                      "gc_collections": r["gc_collections"]}
    if trace_on:
        line["window"]["trace_slowdown"] = r["trace"]["slowdown"]
    line["check"] = r["check"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.manifest import Bench

    bench = Bench()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    mix = bench.traffic(cell["traffic"])
    r = bench.kind(mix["kind"]).run(bench.config(cell["config"]), mix, bench.limits(cell["name"]),
                                    args.seed % 2 ** 63, args.seconds, bool(args.trace), "cuda",
                                    T_START)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": r["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=r["trace"]["busy_s"], window_s=r["trace"]["window_s"])
    line = result_line(bench, cell, r, bool(args.trace), device)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
