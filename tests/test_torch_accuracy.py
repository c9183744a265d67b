"""The port's accuracy suite (``incagg_gnn_tpu_torch/accuracy_suite.py``)
on the CPU at a tiny size: one run of two epochs per row on ``sbm-tiny``,
the JSON layout of ``scripts/accuracy_suite.py`` and the reference
comparison; PNA is refused before any run."""

import json

import pytest
import torch

from incagg_gnn_tpu_torch import accuracy_suite

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


def test_pna_is_refused_before_any_run():
    with pytest.raises(NotImplementedError, match="pna"):
        accuracy_suite.main(["--models", "gcn", "pna", "--device", "cpu"])
