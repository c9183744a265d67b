"""A supervised run of the port's CLI that loses its device at the end of
epoch 1 resumes from epoch 0's checkpoint, and its epochs 1 and 2 (dropout
on) equal an uninterrupted run's bit for bit: the checkpoint carries the
parameters, BatchNorm statistics, Adam, the caches, the device generator
and the loader's epoch.  CPU, sbm-tiny size."""

import os

from incagg_gnn_tpu_torch import __main__ as cli
from torch_cli_helpers import ARGS, records, run_cli


def test_resume_equals_the_uninterrupted_run(tmp_path):
    ck = str(tmp_path / "ck")
    rc, out = run_cli("--checkpoint-dir", ck, "--supervise", "2", "epochs=3",
                      f"metrics_path={tmp_path / 'sup.jsonl'}",
                      env={"INCAGG_FAULT_INJECT": "epoch=1"})
    assert rc == 0, out
    assert out.count("restarting from checkpoint epoch 0") == 1, out
    assert "resumed from checkpoint epoch 0" in out, out
    cli.main([*ARGS, "epochs=3", f"metrics_path={tmp_path / 'ref.jsonl'}"])
    ref = records(tmp_path / "ref.jsonl", "train_epoch")
    sup = records(tmp_path / "sup.jsonl", "train_epoch")
    # the first child ran epochs 0 and 1, the restarted one 1 and 2
    assert [r["loss"] for r in sup] == [ref[0]["loss"], ref[1]["loss"],
                                        ref[1]["loss"], ref[2]["loss"]]
    ref_ev = records(tmp_path / "ref.jsonl", "eval")
    sup_ev = records(tmp_path / "sup.jsonl", "eval")
    assert sup_ev[-1]["val_acc"] == ref_ev[-1]["val_acc"]
    assert sup_ev[-1]["test_acc"] == ref_ev[-1]["test_acc"]
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz"))[-1] == "ckpt_000002.npz"
