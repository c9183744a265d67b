"""The port's checkpoints (``incagg_gnn_tpu_torch/train/checkpoint.py``) on
sbm_tiny: the round trip of the whole training state (a resumed epoch
equals the uninterrupted one), garbage collection keeping two, the fall
back over a corrupt newest file, a changed architecture raising, the
sidecar's best scores; and a checkpoint written by the JAX package's
trainer after one GCN or GCNII epoch, loaded by the port: its refresh
logits within 1e-4 of the JAX ``evaluate``, the next epoch's loss within
1e-5 of the JAX trainer's and the parameters after it within 1e-5."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models.gcn import GCN as JGCN
from incagg_gnn_tpu.models.gcn import GCNConfig as JGCNConfig
from incagg_gnn_tpu.models.gcn2 import GCN2 as JGCN2
from incagg_gnn_tpu.models.gcn2 import GCN2Config as JGCN2Config
from incagg_gnn_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import unflatten
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.loader import PadBuckets
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _trainer(sbm, hidden=16, dropout=0.2, **kw):
    data, in_c, out_c = sbm
    cfg = GCNConfig(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=hidden,
                    out_channels=out_c, num_layers=2, dropout=dropout, drop_input=False)
    tcfg = TrainerConfig(**{**dict(num_parts=4, batch_size=2, seed=0), **kw})
    return Trainer(GCN(cfg, generator=torch.Generator().manual_seed(0)),
                   _port_data(data), tcfg, "cpu")


@pytest.mark.parametrize("mode", ["gas", "vr", "gas-bf16", "vr-hybrid"])
def test_resumed_epoch_equals_the_uninterrupted_one(sbm_tiny, tmp_path, mode):
    """Save after epoch 0, restore into a fresh trainer: its state equals the
    saved one entry for entry, and epoch 1 (dropout on, so the device
    generator, the loader's epoch and Adam all matter) is bit for bit the
    uninterrupted run's."""
    kw = dict(vr_update=mode.startswith("vr"),
              hist_dtype="bfloat16" if mode.endswith("bf16") else "float32",
              adj_format="hybrid" if mode.endswith("hybrid") else "auto")
    a = _trainer(sbm_tiny, **kw)
    a.fill_history()
    a.train_epoch()
    a.evaluate()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a, 0, extra={"best_val": 0.5, "best_test": 0.25})
    want = {k: v.clone() for k, v in a.checkpoint_state().items()}
    loss_a = a.train_epoch()["loss"]
    ev_a = a.evaluate()

    b = _trainer(sbm_tiny, **kw)
    assert mgr.maybe_restore(b)
    assert b.epoch == 1
    assert b.restored_meta["best_val"] == 0.5 and b.restored_meta["best_test"] == 0.25
    got = b.checkpoint_state()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    b.fill_history()
    assert b.train_epoch()["loss"] == loss_a
    assert b.evaluate() == ev_a


def test_files_and_garbage_collection(sbm_tiny, tmp_path):
    """Each save writes ``ckpt_NNNNNN.npz`` and its sidecar by rename (no
    temporary file stays), and only the newest two survive."""
    t = _trainer(sbm_tiny)
    t.fill_history()
    mgr = CheckpointManager(str(tmp_path))
    for epoch in range(4):
        mgr.save(t, epoch)
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_000002.npz", "ckpt_000002.npz.meta.json",
        "ckpt_000003.npz", "ckpt_000003.npz.meta.json"]
    assert mgr.latest().endswith("ckpt_000003.npz")
    with open(tmp_path / "ckpt_000003.npz.meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == 3 and meta["num_entries"] == len(t.checkpoint_state())


def test_corrupt_newest_falls_back(sbm_tiny, tmp_path):
    t = _trainer(sbm_tiny)
    t.fill_history()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(t, 0)
    t.train_epoch()
    mgr.save(t, 1)
    with open(tmp_path / "ckpt_000001.npz", "wb") as f:
        f.write(b"truncated")
    u = _trainer(sbm_tiny)
    with pytest.warns(UserWarning, match="skipping unreadable checkpoint"):
        assert mgr.maybe_restore(u)
    assert u.epoch == 1  # epoch 0's checkpoint


def test_changed_architecture_raises(sbm_tiny, tmp_path):
    t = _trainer(sbm_tiny)
    t.fill_history()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(t, 0)
    with pytest.raises(ValueError, match="different architecture/config"):
        mgr.maybe_restore(_trainer(sbm_tiny, hidden=32))


def test_empty_directory_restores_nothing(sbm_tiny, tmp_path):
    t = _trainer(sbm_tiny)
    assert not CheckpointManager(str(tmp_path / "new")).maybe_restore(t)
    assert t.epoch == 0 and t.restored_meta is None


def test_unflatten_reads_a_treedef_string():
    """The JAX ``PyTreeDef`` string grammar: dicts with sorted keys, lists,
    tuples, custom nodes (optax states) and ``None`` holding no leaf."""
    td = ("PyTreeDef({'a': (*, *), 'b': (CustomNode(namedtuple[EmptyState], []), "
          "CustomNode(namedtuple[ScaleByAdamState], [*, {'w': *}, {'w': *}])), "
          "'c': [None, {'x': *}], 'd': *})")
    t = unflatten(td, list(range(7)))
    assert t["a"] == (0, 1)
    assert t["b"][0] == ("EmptyState", [])
    assert t["b"][1] == ("ScaleByAdamState", [2, {"w": 3}, {"w": 4}])
    assert t["c"] == [None, {"x": 5}] and t["d"] == 6
    with pytest.raises(ValueError, match="more leaves"):
        unflatten(td, list(range(8)))


_JAX_MODELS = {
    "GCN": (JGCN, JGCNConfig, GCN, GCNConfig, 2),
    "GCN2": (JGCN2, JGCN2Config, GCN2, GCN2Config, 3),
}


@pytest.mark.parametrize("name,vr", [("GCN", False), ("GCN", True), ("GCN2", False)])
def test_jax_checkpoint_resumes_in_the_port(sbm_tiny, tmp_path, name, vr):
    """The JAX trainer (clipping and both weight decays, so its optimizer
    chain holds clip, two masked decays and Adam) trains one epoch,
    evaluates and saves with its CheckpointManager; the port restores that
    file, and its refresh, its next epoch and the parameters after it agree
    with the JAX trainer's own next epoch."""
    data, in_c, out_c = sbm_tiny
    jcls, jcfg, tcls, tcfg, layers = _JAX_MODELS[name]
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=16,
                out_channels=out_c, num_layers=layers, dropout=0.0, drop_input=False)
    kw = dict(num_parts=4, batch_size=2, seed=0, vr_update=vr, grad_norm=1.0,
              reg_weight_decay=5e-4, nonreg_weight_decay=1e-4, adj_format="hybrid")
    jt = JTrainer(jcls(jcfg(**arch)), data, JTrainerConfig(**kw))
    jt.fill_history()
    jt.train_epoch()
    jt.evaluate()
    want_logits = np.asarray(jt.out_table)[: data.num_nodes]
    JCheckpointManager(str(tmp_path)).save(jt, 0)
    want_loss = jt.train_epoch()["loss"]

    pt = Trainer(tcls(tcfg(**arch)), _port_data(data), TrainerConfig(**kw), "cpu")
    assert CheckpointManager(str(tmp_path)).maybe_restore(pt)
    assert pt.epoch == 1 and pt.train_loader._epoch == 1
    np.testing.assert_allclose(pt.fill_history(), want_logits, atol=1e-4, rtol=0)
    got_loss = pt.train_epoch()["loss"]
    assert abs(got_loss - want_loss) <= 1e-5, (got_loss, want_loss)
    jparams = jax.tree.map(np.asarray, jt.params)
    for pname, p in pt.model.named_parameters():
        leaf = jparams
        for key in pname.split("."):
            leaf = leaf[int(key)] if isinstance(leaf, (list, tuple)) else leaf[key]
        np.testing.assert_allclose(p.detach().numpy(), leaf, atol=1e-5, rtol=0,
                                   err_msg=pname)


def test_resume_pads_as_the_uninterrupted_run(sbm_small, tmp_path):
    """The training loader's pad buckets grow with the shuffled batches it
    has seen (and the ELL width decides which slots a row sums in the ELL
    part and which in the overflow tail): the checkpoint carries them, so
    the resumed epoch pads, and sums, as the uninterrupted one does."""
    kw = dict(num_parts=16, batch_size=4, adj_format="hybrid")
    a = _trainer(sbm_small, **kw)
    a.fill_history()
    for _ in range(2):
        a.train_epoch()
        a.evaluate()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a, 1)
    saved = dataclasses.replace(a.train_loader.buckets)  # it changes in place
    loss_a = a.train_epoch()["loss"]

    b = _trainer(sbm_small, **kw)
    b.fill_history()
    assert b.train_loader.buckets != saved  # a fresh loader pads otherwise
    assert mgr.maybe_restore(b)
    assert b.train_loader.buckets == saved
    b.fill_history()
    assert b.train_epoch()["loss"] == loss_a


@pytest.mark.parametrize("fmt", ["block", "hybrid"])
def test_restore_keeps_the_buckets_of_a_held_set(sbm_small, tmp_path, fmt):
    """A single-cluster set is collated once and held; its pad buckets grow
    while it is collated.  Restoring an earlier state (saved before the set
    was held) into the same trainer keeps the buckets the held batches were
    collated under, so its next checkpoint describes them, and a fresh
    trainer resumed from that checkpoint trains the next epoch bit for bit
    as this one does, ending in the same state entry for entry."""
    kw = dict(num_parts=4, batch_size=1, adj_format=fmt)
    a = _trainer(sbm_small, **kw)
    a.fill_history()
    early = {k: v.clone() for k, v in a.checkpoint_state().items()}
    a.train_epoch()
    held = dataclasses.replace(a.train_loader.buckets)
    assert held != PadBuckets(*early["loader_buckets"].tolist())
    a.restore_checkpoint(early)
    assert a.train_loader.buckets == held
    a.train_epoch()
    a.evaluate()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a, 1)
    want = a.train_epoch()["loss"]

    b = _trainer(sbm_small, **kw)
    assert mgr.maybe_restore(b)
    b.fill_history()
    assert b.train_epoch()["loss"] == want
    sa, sb = a.checkpoint_state(), b.checkpoint_state()
    assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []
