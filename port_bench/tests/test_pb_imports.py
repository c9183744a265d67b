"""What a run may load, and a run with no card."""

import json
import os
import subprocess
import sys
import types

from port_bench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "incagg_gnn_tpu"}


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_program():
    names = _loaded("import port_bench.reference.train, port_bench.reference.gcn2, "
                    "port_bench.reference.pna, port_bench.check")
    assert not names & (FORBIDDEN | {"incagg_gnn_tpu_torch"}), names


def test_a_run_loads_no_jax():
    code = ("import tempfile, torch\n"
            "from port_bench import run\n"
            "from port_bench.tests import tiny\n"
            "b, name = tiny.bench(tempfile.mkdtemp(), 'gcn2')\n"
            "r = run.run_cell(b, name + '.reverb', 5, 0.1, True, 'cpu', limits=tiny.LIMITS['gcn2'])\n"
            "assert r['correct']\n"
            "assert run.loaded_forbidden() == []\n")
    names = _loaded(code)
    assert "incagg_gnn_tpu_torch" in names and not names & FORBIDDEN, names


def test_forbidden_names_compare_whole(monkeypatch):
    assert run.loaded_forbidden() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "incagg_gnn_tpu_torch_like", types.ModuleType("x"))
    assert "incagg_gnn_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "incagg_gnn_tpu.models", types.ModuleType("x"))
    assert "incagg_gnn_tpu" in run.loaded_forbidden()


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "gcn2-products.reverb", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
