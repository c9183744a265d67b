"""The port's accuracy suite (``incagg_gnn_tpu_torch/accuracy_suite.py``)
on the CPU at a tiny size: one run of two epochs per row on ``sbm-tiny``,
the JSON layout of ``scripts/accuracy_suite.py`` and the reference
comparison; the pna row builds the reference script's PNA and, having no
band in the reference file, is printed without one."""

import json

import numpy as np
import torch

from incagg_gnn_tpu_torch import accuracy_suite
from incagg_gnn_tpu_torch.__main__ import build_model
from incagg_gnn_tpu_torch.graph.datasets import get_data
from incagg_gnn_tpu_torch.models.pna import PNA, compute_avg_deg
from incagg_gnn_tpu_torch.train.config import RunConfig

torch.set_num_threads(2)


def test_suite_writes_the_reference_layout(tmp_path, capsys):
    out = tmp_path / "suite.json"
    res = accuracy_suite.main(["--runs", "1", "--epochs", "2", "--datasets", "sbm-tiny",
                               "--models", "gcn", "gat", "--device", "cpu",
                               "--out", str(out)])
    doc = json.loads(out.read_text())
    assert set(doc) == {"protocol", "results"}
    assert doc["protocol"] == {"runs": 1, "epochs": 2, "hidden": 64, "num_parts": 16,
                               "batch_size": 4, "lr": 0.01, "hist_dtypes": ["float32"]}
    assert list(doc["results"]) == ["sbm-tiny/gcn-gas", "sbm-tiny/gcn-reverb",
                                    "sbm-tiny/gat-gas", "sbm-tiny/gat-reverb"]
    for row in doc["results"].values():
        assert set(row) == {"mean", "std", "runs"} and len(row["runs"]) == 1
        assert 0.0 <= row["mean"] <= 1.0 and row["std"] == 0.0
    # the reference's rows are products rows: listed, none run here
    assert [r[0] for r in res["comparison"]][:2] == ["sbm-products-hard-v4/gcn-gas",
                                                      "sbm-products-hard-v4/gcn-reverb"]
    assert all(r[1] is None for r in res["comparison"])
    assert "not run" in capsys.readouterr().out


def test_comparison_flags_a_row_outside_the_band():
    ref = {"a": {"mean": 0.85, "std": 0.001}, "b": {"mean": 0.5, "std": 0.05}}
    rows = accuracy_suite.compare({"a": {"mean": 0.80, "std": 0.002},
                                   "b": {"mean": 0.55, "std": 0.05}}, ref)
    assert [r[-1] for r in rows] == [True, False]


def test_pna_row_builds_the_reference_architecture():
    """``scripts/accuracy_suite.py``'s pna row: 2 layers, ``true_vr``, no
    input dropout, the default aggregators and scalers, hidden 64, dropout
    0.3, and the degree statistics of the graph's row degrees."""
    data, in_c, out_c = get_data("", "sbm-tiny", seed=0)
    arch = accuracy_suite.architecture("pna", data)
    lin, log = compute_avg_deg(np.diff(data.adj_t.rowptr))
    assert arch == dict(num_layers=2, drop_input=False, avg_deg_lin=lin, avg_deg_log=log,
                        true_vr=True, hidden_channels=64, dropout=0.3)
    model = build_model(RunConfig(model="PNA", dataset="sbm-tiny", architecture=arch),
                        data, in_c, out_c, seed=0)
    c = model.cfg
    assert isinstance(model, PNA) and c.aggregators == ("mean", "max", "min", "sum")
    assert c.scalers == ("identity", "amplification", "attenuation")
    assert (c.avg_deg_lin, c.avg_deg_log, c.num_layers, c.true_vr) == (lin, log, 2, True)
    # six sum/mean branches packed 64 wide, and the degree column
    assert model.hist_dim == 6 * 64 + 1


def test_pna_row_runs_without_a_reference_band(tmp_path, capsys):
    res = accuracy_suite.main(["--runs", "1", "--epochs", "1", "--datasets", "sbm-tiny",
                               "--models", "pna", "--device", "cpu",
                               "--out", str(tmp_path / "suite.json")])
    assert list(res["results"]) == ["sbm-tiny/pna-gas", "sbm-tiny/pna-reverb"]
    assert "sbm-products-hard-v4/pna-gas" not in [r[0] for r in res["comparison"]]
    out = capsys.readouterr().out
    assert out.count("no reference band") == 2 and "FLAGGED" not in out
