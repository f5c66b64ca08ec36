"""The benchmark finds its cells, configurations, traffic and metrics by
name, and a cell added from data files alone runs end to end."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench_port.registry import Registry
from bench_port.run import run_cell

ROOT = Path(__file__).resolve().parent.parent.parent


def test_every_entry_has_its_files():
    reg = Registry(ROOT)
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["source"]
        traffic = reg.traffic(w["traffic"])
        reg.driver(traffic["kind"])
        spec = reg.cell_spec(w["name"])
        assert set(spec["limits"]) >= {"eps", "decode"}
        for trace in (False, True):
            assert reg.metrics(w["name"], trace)
    for m in reg.bench["end_to_end"] + reg.bench["per_layer"]:
        assert callable(reg.reader(m["name"]))


def test_unknown_names_raise():
    reg = Registry(ROOT)
    with pytest.raises(KeyError):
        reg.cell("no_such_cell")
    with pytest.raises(KeyError):
        reg.config("no_such_config")


@pytest.mark.parametrize("cell", ["tiny_video", "tiny_image"])
def test_a_cell_from_data_files_runs(tiny_registry, cell):
    result = run_cell(tiny_registry, cell, 2 ** 31 + 3, 0.0, False,
                      device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    names = {m["name"] for m in tiny_registry.metrics(cell, False)}
    assert set(result["metrics"]) == names - {"peak_mem_gib"}
    assert list(result)[-1] == "checks"
    json.dumps(result)


def test_the_seed_fixes_the_inputs(tiny_registry):
    cell = tiny_registry.cell("tiny_image")
    traffic = tiny_registry.traffic(cell["traffic"])
    drivers = []
    for seed in (11, 11, 12):
        d = tiny_registry.driver("serve").Driver(
            tiny_registry.config("tiny"), traffic,
            tiny_registry.cell_spec("tiny_image"), seed, "cpu", False)
        drivers.append((d.prompt(0), d.row_seeds(0)))
    assert drivers[0] == drivers[1]
    assert drivers[0][1] != drivers[2][1]
