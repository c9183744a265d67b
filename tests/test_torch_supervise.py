"""The port CLI's supervised restart (``incagg_gnn_tpu_torch/__main__.py``)
on the CPU at the sbm-tiny size: a child that dies of an injected device
loss at the end of epoch 0, before any checkpoint exists, is restarted and
runs to the end; and which exceptions count as device loss on CUDA."""

import os

import pytest
import torch

from incagg_gnn_tpu_torch import __main__ as cli
from incagg_gnn_tpu_torch.utils.watchdog import DeviceTimeoutError
from torch_cli_helpers import run_cli


def test_restart_after_device_loss_at_epoch_0(tmp_path):
    ck = str(tmp_path / "ck")
    rc, out = run_cli("--checkpoint-dir", ck, "--supervise", "2", "epochs=2",
                      env={"INCAGG_FAULT_INJECT": "epoch=0"})
    assert rc == 0, out
    assert os.path.exists(os.path.join(ck, ".fault_injected")), out
    assert "device loss: RuntimeError: CUDA error: unspecified launch failure" in out
    # the fault came before epoch 0's save: the restart starts afresh
    assert out.count("restarting from checkpoint epoch -1") == 1, out
    assert out.count("Epoch 0000") == 2 and out.count("Epoch 0001") == 1, out
    assert os.path.exists(os.path.join(ck, ".heartbeat"))
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == [
        "ckpt_000000.npz", "ckpt_000001.npz"]


@pytest.mark.parametrize("exc,lost", [
    (DeviceTimeoutError("device wait exceeded"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("shape mismatch"), False),
    (KeyError("unspecified"), False),
])
def test_device_loss_markers(exc, lost):
    assert cli._is_device_loss(exc) is lost


def test_child_argv_drops_the_supervisor_flags():
    argv = ["--model", "m.yaml", "--supervise", "2", "--supervise-stall-s=5",
            "--checkpoint-dir", "d", "--supervise=3", "--supervise-stall-s", "9",
            "epochs=2"]
    assert cli._child_argv(argv) == ["--model", "m.yaml", "--checkpoint-dir", "d",
                                     "epochs=2"]


def test_supervise_needs_a_checkpoint_dir():
    with pytest.raises(SystemExit):
        cli.main(["--model", "m.yaml", "--dataset", "sbm-small", "--supervise", "1"])
