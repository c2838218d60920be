"""The benchmark's manifest and the files it names.

`BENCHMARK.json` lies at the root of the checkout, beside the benchmark's
folder. A cell names a configuration and a traffic mix; the configuration's
file is the one the manifest gives, the traffic mix is
`traffic/<name>.json` in the benchmark's folder, and every metric is read
by `metrics/<name>.py` there. Nothing about any one cell is written in
code: a new cell, configuration, traffic mix or metric is new files and
new manifest entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)



class Manifest:
    """BENCHMARK.json of `root`, with the benchmark's own files found in
    `bench_dir`."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root = root
        self.bench_dir = bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.data = json.load(fh)
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json "
                             f"(have: {', '.join(sorted(self.cells))})")
        return self.cells[name]

    def config(self, name: str) -> dict:
        """The configuration file's content, with its manifest entry
        under "entry"."""
        entry = self.configs[name]
        with open(os.path.join(self.root, entry["file"])) as fh:
            cfg = json.load(fh)
        cfg["entry"] = entry
        return cfg

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic",
                               f"{name}.json")) as fh:
            return json.load(fh)

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on): those that list the cell, and those without a list
        whose moved metric the cell reports."""
        e2e = [m for m in self.data["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in names
                                 else [])]

    def reader(self, metric: str):
        """The `read(run)` function of metrics/<metric>.py."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
