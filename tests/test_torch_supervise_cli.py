"""The port CLI's remaining recovery and evaluation paths on the CPU at the
sbm-tiny size: the supervisor giving up when every attempt loses the
device without checkpoint progress; ``--eval-only --save-logits`` from a
checkpoint (logits in the original node order, reproducing the last
evaluation); and ``--spill``."""

import numpy as np
import pytest

from incagg_gnn_tpu_torch import __main__ as cli
from incagg_gnn_tpu_torch.graph.datasets import get_data
from torch_cli_helpers import ARGS, run_cli


def test_supervisor_gives_up_without_progress(tmp_path):
    rc, out = run_cli("--checkpoint-dir", str(tmp_path / "ck"), "--supervise", "1",
                      "epochs=2", env={"INCAGG_FAULT_INJECT": "always"})
    assert rc == cli.DEVICE_LOSS_EXIT, out
    assert "giving up" in out, out
    assert out.count("device loss: RuntimeError") == 2, out


def test_eval_only_reproduces_the_last_eval(tmp_path):
    ck = str(tmp_path / "ck")
    run = cli.main([*ARGS, "--checkpoint-dir", ck, "epochs=2"])
    last = run["epochs"][-1]
    path = str(tmp_path / "logits.npy")
    ev = cli.main([*ARGS, "--checkpoint-dir", ck, "--eval-only", "--save-logits", path,
                   "epochs=2"])
    assert abs(ev["best_val"] - last["val_acc"]) <= 1e-4
    assert abs(ev["best_test"] - last["test_acc"]) <= 1e-4
    logits = np.load(path)
    data, _, out_c = get_data("/tmp/datasets", "sbm-tiny")
    assert logits.shape == (data.num_nodes, out_c)
    # rows are in the original node order: argmax on the original labels
    # gives the reported accuracy
    pred = logits.argmax(1)
    acc = float((pred[data.val_mask] == data.y[data.val_mask]).mean())
    assert abs(acc - ev["best_val"]) < 1e-6


def test_save_logits_needs_eval_only(tmp_path):
    with pytest.raises(SystemExit):
        cli.main([*ARGS, "--save-logits", str(tmp_path / "x.npy")])


@pytest.mark.parametrize("vr", [False, True])
def test_spill_flag(vr):
    """``--spill`` trains on host tables and stages bytes both ways."""
    run = cli.main([*ARGS, "--spill", "epochs=2", f"vr_update={str(vr).lower()}"])
    assert 0.0 <= run["best_val"] <= 1.0 and len(run["epochs"]) == 2
    staged = run["spill_bytes"]["eval1"]
    assert staged["h2d"] > 0 and staged["d2h"] > 0
