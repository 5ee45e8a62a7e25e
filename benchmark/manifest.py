"""``BENCHMARK.json`` and the files it names: each configuration, traffic
mix, limit set, traffic kind and metric reader is found by its name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


class Bench:
    def __init__(self, root: str = REPO):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def kind(self, name: str):
        return importlib.import_module(f"benchmark.kinds.{name}")

    def reader(self, metric: str) -> Callable[[dict], object]:
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those with no
        list whose end-to-end metric the cell reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
