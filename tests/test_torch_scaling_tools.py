"""The port's scaling and halo-traffic tools (``scaling_bench.py``,
``halo_model.py``) against the JAX package's scripts: the guards'
verdicts on hand-made rows and artifacts equal ``scripts/scaling_bench.py``'s
(loaded by path: it imports no JAX at module level); the prior guard reads
only the port's own artifacts; and ``halo_model``'s predicted rows,
scheduled payload, padded rows and edge locality equal
``scripts/halo_model.py``'s on one graph at 4 devices, flat and on 2
hosts, the JAX script run in this process on the conftest's CPU mesh.
Nothing is spawned."""

import importlib.util
import json
import os
import sys

import pytest

from incagg_gnn_tpu_torch import halo_model, scaling_bench
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return _script("scaling_bench")


def _row(nd, full, loop, train_share=0.6):
    """A decomposition row: ``full`` and ``loop`` seconds split between
    the train epoch and the refresh."""
    return {"devices": nd, "train_s_full": full * train_share,
            "refresh_s_full": full * (1 - train_share),
            "train_s_loopback": loop * train_share,
            "refresh_s_loopback": loop * (1 - train_share)}


#: (rows, cores): consistent, a loopback slower than its full leg, a
#: larger mesh faster at the same core ceiling, a leg beating one rank by
#: more than the core ratio, both at once, and one row (within the 8%)
ROWS = {
    "consistent": ([_row(1, 10.0, 9.0), _row(2, 6.0, 5.0), _row(4, 4.0, 3.0)], 8),
    "loopback-slower": ([_row(1, 10.0, 9.0), _row(2, 6.0, 7.0), _row(4, 4.0, 3.0)], 8),
    "same-ceiling": ([_row(1, 10.0, 9.0), _row(2, 7.0, 6.0), _row(4, 6.0, 5.0)], 2),
    "beats-core-ratio": ([_row(1, 30.0, 29.0), _row(2, 8.0, 7.0), _row(4, 3.0, 2.0)], 8),
    "both": ([_row(1, 30.0, 29.0), _row(2, 9.0, 12.0), _row(4, 11.0, 10.0)], 2),
    "one-row": ([_row(4, 4.0, 4.2)], 8),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_guards_give_the_jax_scripts_verdicts(jax_bench, case):
    rows, cores = ROWS[case]
    for r in rows:
        assert scaling_bench.row_issues(r) == jax_bench.row_issues(r)
    assert (scaling_bench.cross_row_issues(rows, cores)
            == jax_bench.cross_row_issues(rows, cores))
    assert (scaling_bench.cross_row_flags(rows, cores)
            == jax_bench.cross_row_flags(rows, cores))
    art = {"decomposition": rows,
           "platform": f"virtual CPU mesh, {cores} physical cores shared by all devices"}
    assert scaling_bench.artifact_issues(art) == jax_bench.artifact_issues(art)
    assert (scaling_bench.artifact_issues(art, cores=3)
            == jax_bench.artifact_issues(art, cores=3))
    assert bool(scaling_bench.artifact_issues(art)) == (case not in ("consistent",
                                                                     "one-row"))


def test_guards_on_an_empty_artifact_and_the_ports_platform_label(jax_bench):
    assert scaling_bench.artifact_issues({}) == jax_bench.artifact_issues({}) == [
        "no decomposition rows"]
    rows, _ = ROWS["same-ceiling"]
    # the port labels its host "N host CPUs"; the core count is read from it
    art = {"decomposition": rows, "platform": "CPU ranks over gloo; 2 host CPUs"}
    assert scaling_bench.artifact_issues(art) == jax_bench.artifact_issues(
        {**art, "platform": "2 physical cores"})
    assert scaling_bench.artifact_issues(art)


def test_prior_guard_reads_only_the_ports_artifacts(tmp_path):
    """The newest consistent ``docs/scaling_port_r*.json``: not an invalid
    or inconsistent one, never a JAX ``SCALING_r*.json``."""
    docs = tmp_path / "docs"
    docs.mkdir()
    good = {"decomposition": ROWS["consistent"][0], "platform": "8 host CPUs"}
    (tmp_path / "SCALING_r09.json").write_text(json.dumps(good))
    (docs / "SCALING_r09.json").write_text(json.dumps(good))
    assert scaling_bench.find_prior(None, root=str(tmp_path)) is None
    (docs / "scaling_port_r01.json").write_text(json.dumps(good))
    (docs / "scaling_port_r02.json").write_text(json.dumps({**good, "valid": False}))
    bad = {"decomposition": ROWS["loopback-slower"][0], "platform": "8 host CPUs"}
    (docs / "scaling_port_r03.json").write_text(json.dumps(bad))
    path, art = scaling_bench.find_prior(None, root=str(tmp_path))
    assert os.path.basename(path) == "scaling_port_r01.json" and art == good
    assert scaling_bench.find_prior("none", root=str(tmp_path)) is None
    explicit = str(docs / "scaling_port_r03.json")
    assert scaling_bench.find_prior(explicit) == (explicit, bad)


#: one row of the plans is 0.01 MB (width 1, 10,000 bytes an element), so
#: the JAX script's two-decimal megabytes are its row counts
ARGS = ["--num-nodes", "2000", "--num-parts", "8", "--hidden", "1", "--layers", "2",
        "--dtype-bytes", "10000"]


@pytest.mark.parametrize("hosts", [1, 2])
def test_halo_model_equals_the_jax_script(hosts, monkeypatch, capsys):
    argv = ARGS + ["--n-devices", "4", "--hosts", str(hosts)]
    port = halo_model.main(argv)
    monkeypatch.setattr(sys, "argv", ["halo_model.py"] + argv)
    # the script appends to XLA_FLAGS (after JAX started, to no effect here):
    # restored after the test, for the processes later tests start
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    want = _script("halo_model").main()
    capsys.readouterr()
    assert port["edge_locality"] == want["edge_locality"]
    assert port["graph"] == want["graph"]
    mb = 1 * 10000 / 1e6  # a row
    assert (port["predicted_lower_bound_mb_per_sweep"]
            == want["predicted_lower_bound_mb_per_sweep"]
            == round(port["predicted_rows_per_layer"] * mb, 2))
    for name in ("eval_sweep", "train_epoch"):
        p, w = port[name], want[name]
        for k in ("scheduled_payload_mb", "wire_mb_dense", "wire_mb_ragged",
                  "wire_vs_payload_dense", "wire_vs_payload_ragged",
                  "payload_vs_predicted"):
            assert p[k] == w[k], (name, k)
        assert p["scheduled_payload_mb"] == round(p["payload_rows_per_layer"] * mb * 2, 2)
        assert p["wire_mb_dense"] == round(p["padded_rows_per_layer"] * mb * 2, 2)
        assert p["payload_rows_per_layer"] > 0
    assert "measured_refresh" not in port
    assert port["link_gbps_assumed"] == scaling_bench.NVLINK4_GBPS
