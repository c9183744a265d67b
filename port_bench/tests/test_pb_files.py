"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name: configurations, traffic, per-layer metric readers,
limits."""

import importlib
import json
import math
import os
import re

import pytest

from port_bench import check, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_shape(bench):
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["port_bench"]
    assert all(_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    used = {c["config"] for c in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("port_bench/") and len(c["reduced"]) <= 16
        with open(os.path.join(run.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank", "_channels"))
        importlib.import_module(f"port_bench.reference.{cfg['reference']}").Model


def test_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for c in bench["workloads"]:
        assert set(c) == KEYS["cell"] and c["chips"] == 1 and _line(c["why"])
        assert NAME.match(c["traffic"])
        run.load_cell(bench, c["name"])  # its configuration and traffic, by name
        limits = check.load_limits(run.ROOT, c["name"])
        assert set(limits) == set(check.NUMBERS) and limits["schedule"] == 0
        assert "setup_s" in e2e and any(
            n != "setup_s" and c["name"] in e2e[n].get("workloads", [c["name"]]) for n in e2e)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"] and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock",
                                                                       "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"] and UNIT.match(m["unit"])
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        mod = importlib.import_module(f"port_bench.metrics.{m['name']}")
        assert callable(mod.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
