"""The run on the CPU at a small size: the port's timed path against the
plain reference (both models, GAS and Reverb), and the run with the timed
path broken underneath, which must come out not correct."""

import pytest
import torch

from incagg_gnn_tpu_torch.models.base import ScalableGNN
from incagg_gnn_tpu_torch.train import steps
from incagg_gnn_tpu_torch.train.optim import Optimizer
from port_bench import check, run
from port_bench.tests import tiny

SEED = 2**31 + 12345  # more than 32 signed bits, as a run's seed may be


def _run(tmp_path, model, traffic, trace=False):
    b, name = tiny.bench(str(tmp_path), model)
    return run.run_cell(b, f"{name}.{traffic}", SEED, 0.2, trace, "cpu", limits=tiny.LIMITS[model])


@pytest.mark.parametrize("model,traffic", [("gcn2", "gas"), ("gcn2", "reverb"),
                                           ("pna", "gas"), ("pna", "reverb")])
def test_port_against_reference(tmp_path, model, traffic):
    r = _run(tmp_path, model, traffic, trace=traffic == "reverb")
    got = {k: v["value"] for k, v in r["compared"].items()}
    assert r["correct"], got
    assert list(r["compared"]) == list(check.NUMBERS)
    assert r["attempted"] >= 1 and r["failed"] == 0
    if traffic == "reverb":
        assert r["metrics"]["fused_share"]["value"] == 100.0
        assert r["metrics"]["cache_GiB"]["value"] > 0.0
    else:
        assert set(r["metrics"]) == {"epoch_s", "peak_device_mem", "peak_host_mem", "setup_s"}


def _half_batch(orig):
    def masked_loss(out, y, mask, multilabel):
        keep = mask.clone()
        rows = mask.nonzero()[:, 0]
        keep[rows[rows.shape[0] // 2:]] = False
        return orig(out, y, keep, multilabel)
    return masked_loss


def _altered(orig):
    def refresh(self, *a, **kw):
        logits, out_table = orig(self, *a, **kw)
        out_table[[0, 1]] = out_table[[1, 0]]
        return logits, out_table
    return refresh


@pytest.mark.parametrize("fault,number", [("frozen", "change"), ("half_batch", "loss"),
                                          ("alter", "refresh")])
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault, number):
    """A step that leaves the state unchanged, a loss over half of the
    batch, an answer altered where it is produced: each planted in the
    port, under an otherwise whole run."""
    if fault == "frozen":
        monkeypatch.setattr(Optimizer, "step", lambda self: None)
    elif fault == "half_batch":
        monkeypatch.setattr(steps, "masked_loss", _half_batch(steps.masked_loss))
    else:
        monkeypatch.setattr(ScalableGNN, "refresh", _altered(ScalableGNN.refresh))
    r = _run(tmp_path, "gcn2", "gas")
    assert not r["correct"]
    assert r["compared"][number]["value"] > 10 * tiny.LIMITS["gcn2"][number]


def test_record_is_the_checked_epoch(tmp_path):
    """The window trains on after the checked epoch; what was recorded
    must not move with it (a record that aliased the live state would
    compare the window's last epoch)."""
    b, name = tiny.bench(str(tmp_path), "gcn2")
    s = run.setup(b, f"{name}.gas", SEED, torch.device("cpu"), 0.0)
    before = {k: t.clone() for k, t in s.rec.exp_avg.items()}
    s.trainer.train_epoch()
    s.trainer.evaluate()
    assert all(torch.equal(before[k], s.rec.exp_avg[k]) for k in before)
