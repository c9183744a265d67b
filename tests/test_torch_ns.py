"""Neighbor sampling (``ns``) in the port against the JAX package: the
training loader's batches bit for bit for epochs 0-1 and every step under
one seed (both draw from the shared native sampler), each row capped at
``num_neighbors``; the native sampler itself; the first GAS step of
GraphSAGE on an ``ns`` batch (loss and gradients within 1e-5); the fused
epoch's refusal; and a resumed loader epoch drawing what the uninterrupted
run draws, also through the prefetch thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.graph import relabel as J_relabel
from incagg_gnn_tpu.loader import SubgraphLoader as JLoader
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.graph import relabel as T_relabel
from incagg_gnn_tpu_torch.loader import SubgraphLoader
from incagg_gnn_tpu_torch.train.steps import gas_loss
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from incagg_gnn_tpu_torch.utils.prefetch import prefetch
from test_torch_host import assert_same_tree
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)
from test_torch_sage import _host
from test_torch_trainer import ARCH, MODELS, _leaf, _port_data

torch.set_num_threads(2)
K = 4  # below the graph's mean degree of ~11 with the self-loop


@pytest.fixture(scope="module")
def graph(sbm_small):
    data, _, _ = sbm_small
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    data.adj_t = J_csr.gcn_norm(data.adj_t.set_diag())
    return data, _port_data(data), ptr


def test_native_sampler_matches_jax(graph):
    data, tdata, ptr = graph
    idx = np.arange(ptr[0], ptr[2])
    rowptr, col, value, _ = T_relabel.relabel_one_hop(tdata.adj_t, idx)
    for seed in (0, 17, 2**31 - 1):
        want = J_relabel.sample_neighbors(rowptr, col, value, K, seed=seed)
        got = T_relabel.sample_neighbors(rowptr, col, value, K, seed=seed)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.diff(got[0]).max() == K < np.diff(rowptr).max()
    assert T_relabel.sample_neighbors(rowptr, col, value, -1) == (rowptr, col, value)


@pytest.mark.parametrize("fmt,batch_size", [("hybrid", 2), ("coo", 2), ("hybrid", 1)])
def test_loader_batches_bit_for_bit(graph, fmt, batch_size):
    data, tdata, ptr = graph
    kw = dict(batch_size=batch_size, mode="ns", num_neighbors=K, shuffle=True, seed=5,
              adj_format=fmt)
    jl = JLoader(data, ptr, **kw)
    tl = SubgraphLoader(tdata, ptr, "cpu", **kw)
    # the edge bound min(e, rows * K)
    assert (tl.buckets.rows, tl.buckets.cols, tl.buckets.edges) == (
        jl.buckets.rows, jl.buckets.cols, jl.buckets.edges)
    assert not tl.static_groups
    epochs = []
    for epoch in range(2):
        seen = []
        for jb, tb in zip(jl, tl, strict=True):
            assert np.array_equal(np.asarray(jb.device.n_id), tb.device.n_id.numpy())
            assert_same_tree(jb.device.adj, _host(tb.device.adj))
            assert tb.num_edges == jb.num_edges <= tb.batch_size * K
            if fmt == "coo":
                assert float(tb.device.adj.deg.max()) <= K
            seen.append(tb.num_edges)
        epochs.append(seen)
    # every epoch draws anew (and regroups its clusters)
    assert epochs[0] != epochs[1]


def _trainers(sbm, **kw):
    data, in_c, out_c = sbm
    jcls, jcfg, tcls, tcfg, load = MODELS["GraphSAGE"]
    kw = dict(num_parts=8, batch_size=2, seed=0, epochs=1, **kw)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    jt = JTrainer(jcls(jcfg(**cfg)), data, JTrainerConfig(**kw))
    pt = Trainer(tcls(tcfg(**cfg)), _port_data(data), TrainerConfig(**kw), "cpu")
    load(pt.model, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    return jt, pt


def _jax_gas_grads(jt, batch):
    """Loss and parameter gradients of the JAX trainer's GAS step (jitted)."""
    model, tb = jt.model, jt.tables

    def loss_fn(params, batch, emb):
        x = jnp.take(tb.x, batch.n_id, axis=0).astype(jnp.float32)
        y = jnp.take(tb.y, batch.push_idx, axis=0)
        mask = jnp.take(tb.train_mask, batch.push_idx, axis=0)
        mask = mask & (jnp.arange(batch.push_idx.shape[0]) < batch.batch_size)
        out = model.forward_gas(params, jt.state, x, batch, emb, None, True, True)[0]
        return j_masked_loss(out, y, mask, False)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(jt.params, batch, jt.hist.emb)


def test_first_gas_step_on_an_ns_batch(sbm_tiny):
    jt, pt = _trainers(sbm_tiny, num_neighbors=K, adj_format="hybrid")
    assert jt.train_loader.mode == pt.train_loader.mode == "ns"
    np.testing.assert_allclose(pt.fill_history(), jt.fill_history(), atol=1e-4, rtol=0)
    jb = next(iter(jt.train_loader))
    tb = next(iter(pt.train_loader))
    assert np.array_equal(np.asarray(jb.device.n_id), tb.device.n_id.numpy())
    assert_same_tree(jb.device.adj, _host(tb.device.adj))
    # the sample dropped edges: the batch is not the unsampled one
    unsampled = int(np.diff(pt.data.adj_t.rowptr)[tb.n_id[:tb.batch_size]].sum())
    assert tb.num_edges < unsampled
    jloss, jgrads = _jax_gas_grads(jt, jb.device)
    loss, _, _ = gas_loss(pt.model, tb.device, pt.tables, pt.hist.emb, None)
    pt.opt.zero_grad()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    for name, p in pt.model.named_parameters():
        want = _leaf(jgrads, name)
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


def test_fused_epoch_refuses_ns(sbm_tiny):
    data, in_c, out_c = sbm_tiny
    tcls, tcfg = MODELS["GraphSAGE"][2:4]
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)

    def trainer(**kw):
        return Trainer(tcls(tcfg(**cfg)), _port_data(data),
                       TrainerConfig(num_parts=4, batch_size=2, seed=0, **kw), "cpu")

    tr = trainer(num_neighbors=K, fused_epoch="on")
    reason = "neighbor sampling re-draws every epoch"
    assert tr._fused_epoch_ok([], len(tr.train_loader)) == reason
    tr.fill_history()
    rec = tr.train_epoch()
    assert rec["fused"] is False and rec["reason"] == reason and rec["steps"] >= 1
    # VR batches are in-batch graphs: num_neighbors does not apply (JAX :149-151)
    vr = trainer(num_neighbors=K, vr_update=True)
    assert vr.train_loader.mode == "ib"
    assert vr._fused_epoch_ok([], len(vr.train_loader)) != reason


def test_resumed_epoch_draws_as_the_uninterrupted_run(graph):
    _, tdata, ptr = graph

    def loader():
        return SubgraphLoader(tdata, ptr, "cpu", batch_size=2, mode="ns",
                              num_neighbors=K, shuffle=True, seed=9, adj_format="coo")

    def cols(batches):
        return [hb.device.adj.cols.numpy().copy() for hb in batches]

    run = loader()
    list(run)
    second = cols(run)
    resumed = loader()
    resumed._epoch = 1  # what a checkpoint restores (loader_epoch)
    threaded = loader()
    threaded._epoch = 1
    for got in (cols(resumed), cols(list(prefetch(threaded, 2)))):
        assert len(got) == len(second)
        assert all(np.array_equal(a, b) for a, b in zip(got, second))
