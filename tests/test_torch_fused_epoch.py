"""The port's fused epoch (``train/steps.py::EpochGraph``, the trainer's
``fused_epoch``) against the JAX package's scanned epoch
(``make_*_epoch_scan``), on the CPU, where the port runs the same
static-buffer step eagerly: GCN in GAS and VR on the hybrid pair, GCN VR on
the block format and GCNII GAS, 2 layers, hidden 16, dropout 0, two epochs
(fill, then train and refresh).  Both trainers must take the fused path in
epoch 1; per-epoch loss within 1e-5 and the parameters within 1e-5 after
the second epoch.  Also: a batch with no train row leaves every state as it
was, ``fused_epoch="on"`` runs, and a checkpoint taken after a fused epoch
resumes to the uninterrupted run's next epoch bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCN2 as JGCN2
from incagg_gnn_tpu.models import GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.graph.partition import partition_graph
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)


def _port_data(data, train_mask=None):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y,
        train_mask=data.train_mask if train_mask is None else train_mask,
        val_mask=data.val_mask, test_mask=data.test_mask)


def _leaf(tree, name):
    """The JAX pytree leaf of a port parameter name (``convs.0.w``)."""
    for key in name.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


def _models(name, data, in_c, out_c, batch_norm=False):
    """``batch_norm`` (GCN): the port alone; against JAX the conv bias
    before a BatchNorm has a gradient of rounding noise only, which Adam
    scales up to steps of ``lr`` in either package."""
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                hidden_channels=16, num_layers=2, dropout=0.0, drop_input=False)
    if name == "GCN2":
        return JGCN2(JGCN2Config(**arch)), GCN2(GCN2Config(**arch))
    return JGCN(JGCNConfig(**arch, batch_norm=batch_norm)), \
        GCN(GCNConfig(**arch, batch_norm=batch_norm))


def _pair(data, in_c, out_c, name, kw, train_mask=None):
    """The JAX and port trainers of one configuration, the same weights;
    the JAX trainer's fused epochs are recorded in ``jt.fused``."""
    jm, pm = _models(name, data, in_c, out_c)
    jdata = data if train_mask is None else dataclasses.replace(data, train_mask=train_mask)
    jt = JTrainer(jm, jdata, JTrainerConfig(**kw))
    load_params(pm, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    pt = Trainer(pm, _port_data(data, train_mask), TrainerConfig(**kw), "cpu")
    jt.fused = []
    run = jt._train_epoch_fused

    def spy(batches):
        jt.fused.append(len(jt.fused))
        return run(batches)

    jt._train_epoch_fused = spy
    return jt, pt


def _assert_params(jt, pt, atol=1e-5):
    for name, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(jt.params, name),
                                   atol=atol, rtol=0, err_msg=name)


def _two_epochs(jt, pt):
    """Fill, then two (train, refresh) epochs in both; the per-epoch losses
    and which epochs each trained fused."""
    jt.fill_history()
    pt.fill_history()
    losses, fused = [], []
    for epoch in range(2):
        n_jax = len(jt.fused)
        jl = jt.train_epoch()["loss"]
        pl = pt.train_epoch()["loss"]
        losses.append((jl, pl))
        fused.append((len(jt.fused) > n_jax, pt._last_fused_plan["fused"]))
        jt.evaluate()
        pt.evaluate()
    return losses, fused


CASES = [
    pytest.param("GCN", "hybrid", False, 2, id="gcn-hybrid-gas"),
    pytest.param("GCN", "hybrid", True, 2, id="gcn-hybrid-vr"),
    pytest.param("GCN", "block", True, 1, id="gcn-block-vr"),
    pytest.param("GCN2", "hybrid", False, 1, id="gcn2-hybrid-gas"),
]


@pytest.mark.parametrize("name,fmt,vr,bs", CASES)
def test_fused_epoch_matches_jax(sbm_small, name, fmt, vr, bs):
    data, in_c, out_c = sbm_small
    # lr 1e-3: Adam turns the rounding of a near-zero gradient into a step
    # of up to lr, which the step loops of both packages show alike (6e-5
    # apart after two epochs at the default 1e-2, 1.2e-7 here)
    kw = dict(num_parts=8, batch_size=bs, vr_update=vr, seed=0, adj_format=fmt,
              lr=1e-3)
    jt, pt = _pair(data, in_c, out_c, name, kw)
    losses, fused = _two_epochs(jt, pt)
    assert fused[1] == (True, True), fused
    for jl, pl in losses:
        assert abs(pl - jl) <= 1e-5, losses
    _assert_params(jt, pt)
    if fmt == "block":
        assert pt.train_loader.buckets.blk > 0  # the dense tier trained


def test_fused_epoch_empty_batch_leaves_state(sbm_tiny):
    """A cluster without a train row: both packages leave all state as it
    was for that batch (JAX: ``where(keep)``; the port drops it on the
    host), so the epochs agree; alone, the batch changes nothing."""
    data, in_c, out_c = sbm_tiny
    kw = dict(num_parts=4, batch_size=1, vr_update=False, seed=0, adj_format="hybrid")
    perm, ptr = partition_graph(_port_data(data).adj_t, 4, seed=0)
    mask = data.train_mask.copy()
    mask[perm[ptr[0]:ptr[1]]] = False
    jt, pt = _pair(data, in_c, out_c, "GCN", kw, train_mask=mask)
    losses, fused = _two_epochs(jt, pt)
    assert fused == [(True, True), (True, True)], fused
    for jl, pl in losses:
        assert abs(pl - jl) <= 1e-5, losses
    _assert_params(jt, pt)

    empty = [hb for hb in pt.train_loader._cache
             if not pt._train_mask_host[hb.n_id[: hb.batch_size]].any()]
    assert len(empty) == 1
    before = {k: v.clone() for k, v in pt.checkpoint_state().items()
              if isinstance(v, torch.Tensor)}
    out = pt._train_epoch_fused(empty)
    assert out["loss"] == 0.0 and out["steps"] == 1
    for k, v in pt.checkpoint_state().items():
        if k in before:
            assert torch.equal(v, before[k]), k


def test_fused_epoch_on_and_resume(sbm_tiny, tmp_path):
    """``fused_epoch="on"`` trains fused; a checkpoint saved after a fused
    epoch restores into a new trainer whose next (fused) epoch equals the
    uninterrupted run's bit for bit."""
    data, in_c, out_c = sbm_tiny
    kw = dict(num_parts=4, batch_size=1, vr_update=False, seed=0,
              adj_format="hybrid", fused_epoch="on")

    def trainer():
        _, m = _models("GCN", data, in_c, out_c, batch_norm=True)
        torch.manual_seed(0)
        return Trainer(m, _port_data(data), TrainerConfig(**kw), "cpu")

    a = trainer()
    a.fill_history()
    a.train_epoch()
    assert a._last_fused_plan["fused"]
    a.evaluate()
    CheckpointManager(str(tmp_path)).save(a, 0)
    want = a.train_epoch()["loss"]
    b = trainer()
    assert CheckpointManager(str(tmp_path)).maybe_restore(b)
    b.fill_history()
    got = b.train_epoch()
    assert got["fused"] and got["loss"] == want
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
