"""The port's liveness machinery on the CPU: the supervisor kills a child
whose heartbeat goes stale (an injected silent hang) and restarts it; the
device watchdog passes a healthy run through and raises
``DeviceTimeoutError`` on a stalled wait; the heartbeat file; the metrics
JSONL of the trainer's ``train_epoch`` and ``eval`` records; the step timer
and the ``torch.profiler`` trace."""

import json
import os
import time

import pytest
import torch

from incagg_gnn_tpu_torch.graph.datasets import make_sbm
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from incagg_gnn_tpu_torch.utils import heartbeat, watchdog
from incagg_gnn_tpu_torch.utils.watchdog import DeviceTimeoutError, Watchdog
from torch_cli_helpers import run_cli

torch.set_num_threads(2)


def test_supervisor_kills_a_stalled_child(tmp_path):
    ck = str(tmp_path / "ck")
    rc, out = run_cli("--checkpoint-dir", ck, "--supervise", "2",
                      "--supervise-stall-s", "3", "epochs=2",
                      env={"INCAGG_FAULT_INJECT": "hang_epoch=0"})
    assert rc == 0, out
    assert "hanging forever at epoch 0" in out and "no heartbeat" in out, out
    assert "Epoch 0001" in out, out
    assert os.path.exists(os.path.join(ck, ".heartbeat"))


def _trainer(**kw):
    data, in_c, out_c = make_sbm(num_nodes=400, num_classes=4, num_features=16,
                                 avg_degree=8.0, seed=1)
    cfg = GCNConfig(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=16,
                    out_channels=out_c, num_layers=2)
    return Trainer(GCN(cfg, generator=torch.Generator().manual_seed(0)), data,
                   TrainerConfig(num_parts=4, batch_size=2, seed=0, **kw), "cpu")


def test_watchdog_passes_a_healthy_run_through():
    t = _trainer(device_timeout_s=120.0, epochs=2)
    res = t.fit()
    assert t.watchdog.stalls == 0 and t.epoch == 2
    assert 0.0 <= res["best_test"] <= 1.0


def test_watchdog_times_out_on_a_stall(monkeypatch):
    """A wait that never completes raises with diagnostics instead of
    hanging; the warning fires first."""
    monkeypatch.setattr(watchdog, "_block", lambda marker: time.sleep(10))
    wd = Watchdog(timeout_s=0.3, warn_fraction=0.5)
    t0 = time.monotonic()
    with pytest.raises(DeviceTimeoutError, match="failing fast"):
        wd.wait({"loss": torch.zeros(())}, label="unit stall")
    assert time.monotonic() - t0 < 5.0
    assert wd.stalls == 1


def test_watchdog_reraises_a_device_error(monkeypatch):
    def fail(marker):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(watchdog, "_block", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        Watchdog(timeout_s=5.0).wait(torch.zeros(()))


def test_heartbeat_touches_the_file_when_asked(tmp_path, monkeypatch):
    path = tmp_path / "hb"
    monkeypatch.delenv(heartbeat.ENV_VAR, raising=False)
    heartbeat.beat(min_interval_s=0.0)
    assert not path.exists()
    monkeypatch.setenv(heartbeat.ENV_VAR, str(path))
    heartbeat.beat(min_interval_s=0.0)
    assert path.exists()


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    t = _trainer(vr_update=True, metrics_path=path)
    t.metrics_from_logits(t.fill_history())
    t.train_epoch()
    t.evaluate()
    t.metrics.close()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert [r["kind"] for r in recs] == ["eval", "train_epoch", "eval"]
    tr = recs[1]
    for key in ("loss", "drift", "epoch_s", "steps", "edges_per_s"):
        assert isinstance(tr[key], float), key
    assert "eval_s" in recs[2] and 0.0 <= recs[2]["val_acc"] <= 1.0


def test_step_timer_and_profile_trace(tmp_path):
    from incagg_gnn_tpu_torch.utils.logging import StepTimer, profile_trace

    timer = StepTimer()
    with profile_trace(str(tmp_path / "trace")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.stop(x) > 0.0
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with profile_trace(None):  # no directory: nothing traced
        pass
