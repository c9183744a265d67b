"""The bodies of the multi-device programs that NCCL captures as CUDA
graphs, run eagerly on four gloo CPU ranks (spawned once for the module),
against what runs there, bit for bit:

- ``ShardedVRTrainer``'s Reverb epoch body (every round's step, all-reduce
  and Adam; ``_train_epoch_fused``'s eager warm-up, JAX
  ``_make_fused_epoch``) against the looped epoch;
- its refresh's layer passes as a capture holds them (``_layer_passes``,
  JAX ``_make_refresh_layer``'s scan), bound once and run as two replays
  from one state written back in place, against the eager pipelined
  refresh from that state;
- a mesh ``Trainer``'s fused epoch (``EpochGraph``'s step over static
  buffers, eager on the CPU as on one device) against its looped epoch;
- and the records that say why the programs run eagerly over gloo."""

import numpy as np
import pytest
import torch

from incagg_gnn_tpu_torch.graph.datasets import make_sbm
from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks
from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

torch.set_num_threads(1)
WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from torch_sharded_ranks import SeededModel, capture_bodies

    data, in_c, out_c = make_sbm(num_nodes=2000, num_classes=8, num_features=32,
                                 avg_degree=10.0, seed=2)
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=16,
                out_channels=out_c, num_layers=2, dropout=0.0, drop_input=False)
    make = SeededModel("GCN", arch)
    kw = dict(num_parts=8, batch_size=1, seed=0, lr=0.01, adj_format="hybrid",
              vr_update=True)
    # the mesh Trainer's single-cluster Reverb batches, grouped once: one
    # shape, so the epoch fuses
    mesh_case = (make, data, TrainerConfig(num_parts=8, batch_size=1, seed=0,
                                           vr_update=True, static_groups=True))
    work = tmp_path_factory.mktemp("capture")
    return spawn_ranks(capture_bodies, WORLD, [torch.device("cpu")] * WORLD, "gloo",
                       args=(make, kw, data, mesh_case), workdir=str(work / "run"),
                       threads=1)


def _equal_params(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_sharded_epoch_body_matches_loop(ranks):
    """One Reverb epoch as the captured program's body equals the loop:
    parameters and caches bit for bit, the device-summed loss within f32
    rounding of the loop's f64 sum."""
    for r in ranks:
        looped, body = r["epoch"]["looped"], r["epoch"]["body"]
        _equal_params(looped["params"], body["params"])
        for a, b in zip(looped["caches"], body["caches"]):
            assert np.array_equal(a, b)
        assert body["loss"] == pytest.approx(looped["loss"], rel=1e-6)
        assert body["record"]["fused"] and body["record"]["warmup"]
        assert body["record"]["steps"] == looped["record"]["steps"]


def test_sharded_refresh_body_matches_pipelined(ranks):
    """The refresh's layer passes as a capture holds them (bound once,
    reading and writing the tables by address), run as two replays from
    one state written back in place, each equal the pipelined refresh from
    that state bit for bit."""
    for r in ranks:
        lp, cp = r["refresh"]["pipelined"]
        assert len(r["refresh"]["replays"]) == 2
        for ls, cs in r["refresh"]["replays"]:
            assert np.array_equal(lp, ls)
            assert len(cs) == len(cp)
            for a, b in zip(cp, cs):
                assert np.array_equal(a, b)


def test_mesh_fused_epoch_body_matches_loop(ranks):
    """A mesh ``Trainer``'s fused epoch (the step it captures under NCCL,
    eager here) equals its looped epoch: parameters bit for bit."""
    for r in ranks:
        looped, fused = r["mesh"]["looped"], r["mesh"]["fused"]
        assert fused["record"]["fused"], fused["record"]["reason"]
        assert not looped["record"]["fused"]
        _equal_params(looped["params"], fused["params"])
        assert fused["loss"] == pytest.approx(looped["loss"], rel=1e-6)


def test_gloo_records_name_the_reason(ranks):
    """Over gloo on the CPU each program runs eagerly, and its record says
    why: the sharded epoch and refresh, the mesh epoch and refresh."""
    for r in ranks:
        rec = r["epoch"]["looped"]["record"]
        assert not rec["fused"] and "CUDA graphs" in rec["reason"]
        plan = r["refresh_plan"]
        assert plan["mechanism"] == "pipelined" and "CUDA graphs" in plan["reason"]
        assert plan["captures"] == 0
        mesh = r["mesh"]["looped"]
        assert "CUDA graphs" in mesh["record"]["reason"]
        assert mesh["refresh_plan"]["mechanism"] == "eager"
        assert "CUDA graphs" in mesh["refresh_plan"]["reason"]
