"""The port's staleness suite (``python -m
incagg_gnn_tpu_torch.staleness_stress``) on the CPU at the sbm-tiny size, 2
epochs, 2 of its configurations: its JSON keeps the JAX record's layout
(``docs/staleness_stress_r04.json``) and adds the device and how each
configuration's refreshes ran; ``--compare`` flags a row off its reference
by more than the band, and not one inside it."""

import json
import os

import torch

from incagg_gnn_tpu_torch.staleness_stress import CONFIGS, main

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_suite_schema_and_compare(tmp_path):
    def row(*vals):  # a reference row with one run per value
        runs = [{"best": v, "acc5": v, "acc10": v, "epochs_to_thresh": None} for v in vals]
        return {"best": sum(vals) / len(vals), "runs": runs}

    # gas-stress: 0.0 with no spread, far below any trained run (flagged);
    # gas-frozen: runs 0 and 1, a band of 1.01 no accuracy leaves
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"results": {"gas-stress": row(0.0),
                                           "gas-frozen": row(0.0, 1.0),
                                           "mlp": row(0.5)}}))
    out = tmp_path / "port.json"
    res = main(["--runs", "1", "--epochs", "2", "--dataset", "sbm-tiny", "--device", "cpu",
                "--configs", "gas-stress", "gas-frozen", "--out", str(out),
                "--compare", str(ref)])
    with open(os.path.join(ROOT, "docs", "staleness_stress_r04.json")) as f:
        jax_record = json.load(f)
    with open(out) as f:
        got = json.load(f)
    assert set(got["protocol"]) == set(jax_record["protocol"])
    assert got["protocol"]["epochs"] == 2 and got["device"]["platform"] == "cpu"
    assert list(got["results"]) == ["gas-stress", "gas-frozen"]
    jax_row = jax_record["results"]["gas-stress"]
    for name, r in got["results"].items():
        assert set(jax_row) <= set(r) and len(r["runs"]) == 1
        assert set(jax_row["runs"][0]) == set(r["runs"][0])
        assert 0.0 < r["best"] <= 1.0 and r["refresh"]["seconds"] > 0.0
    # the fill sweeps the whole set; a refresh_frac window runs on layers
    assert got["results"]["gas-stress"]["refresh"]["mechanisms"] == {"sweep": 1, "layers": 2}
    assert got["results"]["gas-frozen"]["refresh"]["mechanisms"] == {"sweep": 3}
    flagged = {(metric, name): f for metric, name, *_, f in res["comparison"]}
    assert flagged == {(m, n): f for m in ("best", "acc10") for n, f in (
        ("gas-stress", True), ("gas-frozen", False), ("mlp", None))}
    assert set(CONFIGS) == set(jax_record["results"])
