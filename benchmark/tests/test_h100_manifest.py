"""BENCHMARK.json names only configurations, mixes and metric readers that
exist, in the characters and sizes the benchmark's rules allow."""

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.cell import load_cell, load_module  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [
        m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for entry in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for c in MANIFEST["configs"]:
        assert 1 <= len(c["source"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    """Each cell finds its configuration, mix, generator and readers, and
    reports setup_s, one more end-to-end metric and a per-layer metric."""
    c = load_cell(cell)
    assert c.config["reduced"] == [] and c.config["limits"]
    gen = load_module(BENCH / "generators" / f"{c.mix['generator']}.py")
    for step in ("setup", "install", "window", "release", "check"):
        assert callable(getattr(gen.Run, step)), step
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(load_module(BENCH / "metrics"
                                    / f"{m['name']}.py").read)


def test_metrics_rules():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            w = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in w, (m["name"], cell)


def test_chips():
    four = [w for w in MANIFEST["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert len(four) <= max(1, len(CELLS) // 4)
