"""Finds everything by name: the cells, configurations and metrics of
``BENCHMARK.json``, and the files of ``bench_port/`` that belong to each.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  generator that reads it (``drivers/<kind>.py``);
- a cell: ``cells/<workload>.json`` (its correctness limits and how many
  of its answers the reference checks);
- a metric, end-to-end or per layer: ``metrics/<name>.py``, whose
  ``read(run)`` returns the number or None.

A cell, traffic mix or metric added later is data and files here; no
file of the harness changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path, here: Path = HERE):
        self.root = Path(root)
        self.here = Path(here)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _json(self, *parts):
        with open(self.here.joinpath(*parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def cell_spec(self, name: str) -> dict:
        return self._json("cells", f"{name}.json")

    def metrics(self, workload: str, trace: bool):
        """The entries of the metrics this cell reports in this kind of
        run: per-layer with --trace 1, end-to-end otherwise."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or workload in m["workloads"]]

    def driver(self, kind: str):
        return importlib.import_module(f"bench_port.drivers.{kind}")

    def reader(self, metric: str):
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_port.metrics." + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
