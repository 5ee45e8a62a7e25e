"""Readings that a cell's limits are set from.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 [--faults a,b] [--out FILE]

For each seed, at the cell's own sizes, the compared numbers of the
program (the lower readings), of the control (the reference computed in
float8 e4m3, both operands of every product rounded under one scale a
tensor, in the program's place: one precision below the configuration's
bf16), of the program's own lower path where it has one, and of each fault
named, planted under the program: the cell's kind's ``readings``.

One JSON line a seed on standard output (and appended to ``--out``). The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.manifest import Bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.workload(args.workload)
    cfg, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload,
                **bench.kind(mix["kind"]).readings(cfg, mix, seed % 2 ** 63, faults=faults),
                "seconds": time.perf_counter() - t0}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
