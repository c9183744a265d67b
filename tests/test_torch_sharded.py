"""The port's sharded trainer (``parallel/spatial.py``), four gloo ranks on
the CPU spawned once for the module, against the JAX package's
``ShardedVRTrainer`` on ``make_mesh(4)`` of the conftest's virtual CPU
mesh, with the JAX trainer's parameters carried across by ``convert.py``
and dropout off: refresh logits within 1e-4 (GCN hybrid, GCNII block),
the first step's gradients within 1e-5, the parameters after one Reverb
epoch and one GAS epoch within 1e-4; the ``dense`` and ``ragged`` wires
bit for bit; the exchange's forward and backward against autograd of a
one-process emulation; a resumed run equal to the uninterrupted one; and
the launcher's refusals and failure code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCN2 as JGCN2
from incagg_gnn_tpu.models import GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.parallel.mesh import make_mesh
from incagg_gnn_tpu.parallel.spatial import ShardedVRTrainer as JSharded
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel.launch import RankFailed, memory_gate, spawn_ranks
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(1)
WORLD = 4
CASES = {
    "gcn-hybrid-vr": ("GCN", dict(adj_format="hybrid", vr_update=True)),
    "gcn-hybrid-gas": ("GCN", dict(adj_format="hybrid", vr_update=False)),
    "gcn2-block-vr": ("GCN2", dict(adj_format="block", vr_update=True)),
}


def _arch(data, in_c, out_c, name):
    return dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                hidden_channels=16 if name == "GCN" else 24, num_layers=2,
                dropout=0.0, drop_input=False)


def _port_model(name, arch):
    return GCN(GCNConfig(**arch)) if name == "GCN" else GCN2(GCN2Config(**arch))


def _named(name, arch, tree, state):
    """A JAX parameter tree (parameters or gradients) by the port's names."""
    m = _port_model(name, arch)
    load_params(m, jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, state))
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


def _jax_first_grads(jt):
    """The JAX trainer's first Reverb step's gradients (round 0): each
    device's gradient of its masked loss on its slab, weighted by its
    train rows and normalized by their total (JAX ``_vr_step_core``)."""
    slab, model = jt.layout.slab, jt.model
    stack = jax.tree.map(np.asarray, jt._train_stacks[0])
    total, n_tot = None, 0.0
    for d in range(jt.n_dev):
        rows = slice(d * slab, (d + 1) * slab)
        b = jax.tree.map(lambda a: jnp.asarray(a[d]), stack)
        hist = type(jt.hist)(tuple(t[rows] for t in jt.hist.emb),
                             tuple(t[rows] for t in jt.hist.emb_ag))
        x = jnp.take(jt.x_tab[rows], b.n_id, axis=0)
        y = jnp.take(jt.y_tab[rows], b.push_idx, axis=0)
        mask = jnp.take(jt.tm_tab[rows], b.push_idx, axis=0) & (
            jnp.arange(b.push_idx.shape[0]) < b.batch_size)

        def loss_fn(p):
            out, _, _ = model.forward_vr(p, jt.state, x, b, hist, jax.random.PRNGKey(0),
                                         True, jt.cfg.drift_norm)
            return j_masked_loss(out, y, mask, jt.multilabel)

        (_, n), g = jax.value_and_grad(loss_fn, has_aux=True)(jt.params)
        g = jax.tree.map(lambda a: np.asarray(a, np.float64) * float(n), g)
        total = g if total is None else jax.tree.map(np.add, total, g)
        n_tot += float(n)
    return jax.tree.map(lambda a: (a / max(n_tot, 1.0)).astype(np.float32), total)


@pytest.fixture(scope="module")
def runs(sbm_small, tmp_path_factory):
    """The JAX trainers' results and the port ranks' results, once.

    The JAX trainers run their ``shard_map`` with ``check_vma=False``.
    Under the default, this JAX differentiates the replicated parameters
    with an implicit ``psum``, so the step's ``psum`` of the gradients
    weighted by each device's train rows applies ``Σ_d g_d``, not the
    global mean over train rows that its code spells out
    (``incagg_gnn_tpu/parallel/spatial.py:750-755``) and the port computes.
    Without the check the same code reduces as written."""
    import functools

    import incagg_gnn_tpu.parallel.spatial as J_spatial

    data, in_c, out_c = sbm_small
    jax_res, cases = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_spatial, "shard_map", functools.partial(jax.shard_map,
                                                             check_vma=False))
        _jax_runs(data, in_c, out_c, jax_res, cases)
    pdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    work = tmp_path_factory.mktemp("sharded")
    ranks = spawn_ranks(_rank_fn(), WORLD, [torch.device("cpu")] * WORLD, "gloo",
                        args=(cases, pdata, str(work / "ckpt")), workdir=str(work / "run"),
                        threads=1)
    return jax_res, ranks, data.num_nodes


def _jax_runs(data, in_c, out_c, jax_res, cases):
    for tag, (name, fmt) in CASES.items():
        arch = _arch(data, in_c, out_c, name)
        kw = dict(num_parts=8, batch_size=1, seed=0, lr=0.01, **fmt)
        jm = JGCN(JGCNConfig(**arch)) if name == "GCN" else JGCN2(JGCN2Config(**arch))
        jt = JSharded(jm, data, JTrainerConfig(**kw), mesh=make_mesh(WORLD))
        params = jax.tree.map(np.asarray, jt.params)
        state = jax.tree.map(np.asarray, jt.state)
        cases[tag] = (name, arch, kw, params, state)
        logits = jt.fill_history()
        grads = _jax_first_grads(jt) if fmt["vr_update"] else None
        loss = jt.train_epoch()["loss"]
        jax_res[tag] = {"logits": logits, "loss": loss,
                        "grads": None if grads is None else _named(name, arch, grads,
                                                                   jt.state),
                        "params": _named(name, arch, jt.params, jt.state)}


def _rank_fn():
    from torch_sharded_ranks import parity

    return parity


@pytest.mark.parametrize("tag", ["gcn-hybrid-vr", "gcn-hybrid-gas", "gcn2-block-vr"])
def test_refresh_matches_jax(runs, tag):
    jax_res, ranks, _ = runs
    want = jax_res[tag]["logits"]
    for r in ranks:
        np.testing.assert_allclose(r[tag]["logits"], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tag", ["gcn-hybrid-vr", "gcn2-block-vr"])
def test_first_step_grads_match_jax(runs, tag):
    jax_res, ranks, _ = runs
    want = jax_res[tag]["grads"]
    for r in ranks:
        assert set(r[tag]["grads"]) == set(want)
        for k, g in r[tag]["grads"].items():
            np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("tag", ["gcn-hybrid-vr", "gcn-hybrid-gas", "gcn2-block-vr"])
def test_epoch_params_match_jax(runs, tag):
    """One Reverb epoch (rounds in stack order, JAX's scan) or one GAS
    epoch (rounds permuted by ``(seed, 0)``): parameters within 1e-4 of
    JAX's, equal on every rank; the epoch's loss within 1e-5."""
    jax_res, ranks, _ = runs
    want = jax_res[tag]["params"]
    for r in ranks:
        for k, p in r[tag]["params"].items():
            np.testing.assert_allclose(p, want[k], atol=1e-4, rtol=0, err_msg=k)
            assert np.array_equal(p, ranks[0][tag]["params"][k]), k
        assert abs(r[tag]["loss"] - jax_res[tag]["loss"]) <= 1e-5


def test_dense_and_ragged_wires_agree_bit_for_bit(runs):
    _, ranks, _ = runs
    for r in ranks:
        dense, ragged = r["wires"]["dense"], r["wires"]["ragged"]
        assert (dense["wire"], ragged["wire"]) == ("dense", "ragged")
        assert np.array_equal(dense["logits"], ragged["logits"])
        for a, b in zip(dense["caches"], ragged["caches"]):
            assert np.array_equal(a, b)
        for k in dense["params"]:
            assert np.array_equal(dense["params"][k], ragged["params"][k]), k
        assert np.array_equal(dense["out"], ragged["out"])
        assert dense["calls"]["all_to_all"] > 0


@pytest.mark.parametrize("wire", ["dense", "ragged"])
def test_exchange_backward_matches_autograd_emulation(runs, wire):
    """One process emulates the round-0 exchange as a gather of the global
    rows ``n_id`` from the stacked slabs; autograd of that gather gives
    each slab's cotangent, which the ranks' transposed exchange must
    equal (the forward: bit for bit)."""
    _, ranks, _ = runs
    res = [r["wires"][wire] for r in ranks]
    table = torch.tensor(np.concatenate([r["src"] for r in res]), requires_grad=True)
    outs = [table.index_select(0, torch.from_numpy(r["n_id"])) for r in res]
    for o, r in zip(outs, res):
        assert np.array_equal(o.detach().numpy(), r["out"])
    loss = sum((o * torch.from_numpy(r["g"])).sum() for o, r in zip(outs, res))
    (d_table,) = torch.autograd.grad(loss, table)
    slab = res[0]["src"].shape[0]
    for i, r in enumerate(res):
        np.testing.assert_allclose(r["d_src"], d_table[i * slab:(i + 1) * slab].numpy(),
                                   atol=1e-5, rtol=0)


def test_resumed_run_equals_the_uninterrupted_one(runs):
    _, ranks, _ = runs
    for r in ranks:
        res = r["resume"]
        assert res["restored"] and res["start"] == 1
        assert res["loss"][0] == res["loss"][1]
        assert res["eval"][0] == res["eval"][1]
        for k in res["params"][0]:
            assert np.array_equal(res["params"][0][k], res["params"][1][k]), k
        for a, b in zip(*res["caches"]):
            assert np.array_equal(a, b)


def test_failing_rank_fails_the_run(tmp_path):
    from torch_sharded_ranks import failing

    with pytest.raises(RankFailed) as e:
        spawn_ranks(failing, 2, [torch.device("cpu")] * 2, "gloo", workdir=str(tmp_path),
                    threads=1)
    assert e.value.rank == 1 and e.value.code == 1


def test_refusals(sbm_small, monkeypatch):
    """NCCL with two ranks on one device, GAT and PNA, and a slab over the
    memory budget are refused, each naming what to use or the slice that
    brings it."""
    from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
    from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
    from incagg_gnn_tpu_torch.parallel.spatial import check_sharded
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        M.place_ranks("cpu", 2, "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        M.place_ranks("cuda:0", 2, "nccl")
    assert M.place_ranks("cuda:0", 2, "gloo") == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--device cuda:0 --dist-backend gloo"):
        M.place_ranks("cuda", 2, "nccl")
    data, in_c, out_c = sbm_small
    base = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                hidden_channels=16, num_layers=2)
    for m in (GAT(GATConfig(**base)),
              PNA(PNAConfig(**base, avg_deg_lin=1.0, avg_deg_log=1.0))):
        with pytest.raises(NotImplementedError, match="sharded GAT and PNA"):
            check_sharded(m, TrainerConfig())
    with pytest.raises(NotImplementedError, match="scaling_bench"):
        check_sharded(_port_model("GCN", _arch(data, in_c, out_c, "GCN")),
                      TrainerConfig(halo_wire="loopback"))
    cfg = GCNConfig(**base)
    monkeypatch.setenv("INCAGG_HBM_BUDGET_MB", "1")
    with pytest.raises(NotImplementedError, match="sharded spill tier"):
        memory_gate(cfg, 64, "float32", data.num_nodes, [torch.device("cpu")] * 4)
    monkeypatch.setenv("INCAGG_HBM_BUDGET_MB", "1000")
    gate = memory_gate(cfg, 64, "float32", data.num_nodes, [torch.device("cpu")] * 4)
    assert gate["cpu"]["ranks"] == 4
