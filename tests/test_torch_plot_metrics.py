"""``scripts/plot_metrics.py``, unchanged, over the port's metrics: a
2-epoch Reverb/VR run of the port's CLI on the CPU (GCN's sbm-small
hyperparameters on the sbm-tiny graph, the step loop) writes its JSONL through
``metrics_path=``, the script plots it, and the four dashboards (loss,
drift, epoch time, accuracy) must be written from records that carry the
keys the script reads."""

import os
import subprocess
import sys

import pytest
import torch

from incagg_gnn_tpu_torch.__main__ import main
from torch_cli_helpers import ARGS, ROOT, records

torch.set_num_threads(2)


def test_plot_metrics_over_a_port_run(tmp_path):
    pytest.importorskip("matplotlib")
    path = tmp_path / "m.jsonl"
    # the step loop records each epoch's drift (a fused epoch's record says 0);
    # quoted: YAML reads a bare off as False
    main([*ARGS, "epochs=2", "vr_update=true", "fused_epoch='off'", f"metrics_path={path}"])
    train, evals = records(path, "train_epoch"), records(path, "eval")
    assert len(train) == 2 and len(evals) == 3  # the fill's eval and one an epoch
    for r in train:
        assert {"loss", "drift", "epoch_s"} <= set(r)
    assert any(r["drift"] for r in train)  # VR: the drift dashboard is drawn
    for r in evals:
        assert {"train_acc", "val_acc", "test_acc"} <= set(r)
    out = tmp_path / "plots"
    p = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "plot_metrics.py"),
                        str(path), "--out", str(out)], capture_output=True, text=True,
                       timeout=120, env={**os.environ, "MPLBACKEND": "Agg",
                                         "MPLCONFIGDIR": str(tmp_path / "mpl")})
    assert p.returncode == 0, p.stdout + p.stderr
    for name in ("loss.png", "drift.png", "epoch_time.png", "accuracy.png"):
        assert (out / name).stat().st_size > 0, name
