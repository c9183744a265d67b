"""The port's scanned refresh (``models/base.py::ScalableGNN.refresh`` with
``scan=True``: the ``sweep`` and ``layers`` mechanisms, which on the CPU
run their step functions eagerly on the held batches or on static batch
buffers) against the JAX package's scanned refresh, 2 layers, widths <= 16,
the same weights (``convert.load_params``).

- The fill (``refresh(scan=True)`` from zero caches) of GCN global hybrid
  VR, GCNII global (``needs_x0``), GCN ``block-fwd`` GAS, GAT hybrid, PNA
  hybrid and PNA_JK: logits and caches within 2e-5 of the JAX fill, and the
  plan's ``use_scan``, ``on_device``, ``homogeneous``, ``n_batches`` and
  ``global_cols`` equal to the JAX plan's (PNA_JK overrides the per-batch
  refresh: ``use_scan`` False in both, the port's ``eager`` loop).
- The port's ``scan=True`` and ``scan=False`` sweeps agree bit for bit.
- The ``layers`` path: a ``refresh_frac=0.5`` run over two epochs against
  the JAX trainer's; a set held on the host against the eager sweep; and
  the JAX package's own chunked case (``tests/test_trainer_features.py``
  ``TestChunkedDeviceScanRefresh``: 70 batches, a budget of 3 batches),
  where the port's sweep reads the held set in place (``resident``: the
  loader holds it on the device) and JAX scans chunks of a stacked copy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph.datasets import make_sbm
from incagg_gnn_tpu.models import GAT as JGAT, GATConfig as JGATConfig
from incagg_gnn_tpu.models import GCN as JGCN, GCNConfig as JGCNConfig
from incagg_gnn_tpu.models import GCN2 as JGCN2, GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import PNA as JPNA, PNAConfig as JPNAConfig
from incagg_gnn_tpu.models import pna_jk as J_pna_jk
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.loader import _tensors
from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
from incagg_gnn_tpu_torch.models.pna_jk import PNA_JK, PNAJKConfig
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 2e-5
#: the plan keys both packages compute from the predicate's inputs
KEYS = ("use_scan", "on_device", "homogeneous", "n_batches", "global_cols")


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _models(name, data, in_c, out_c):
    common = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                  num_layers=2, dropout=0.0)
    if name == "gcn":
        kw = dict(common, hidden_channels=16, drop_input=False)
        return JGCN(JGCNConfig(**kw)), GCN(GCNConfig(**kw))
    if name == "gcn2":
        kw = dict(common, hidden_channels=16, drop_input=False, shared_weights=False,
                  alpha=0.1, theta=0.5)
        return JGCN2(JGCN2Config(**kw)), GCN2(GCN2Config(**kw))
    if name == "gat":
        kw = dict(common, hidden_channels=8, hidden_heads=2)
        return JGAT(JGATConfig(**kw)), GAT(GATConfig(**kw))
    kw = dict(common, hidden_channels=8, aggregators=("mean", "max"), scalers=("identity",))
    if name == "pna":
        return JPNA(JPNAConfig(**kw)), PNA(PNAConfig(**kw))
    return J_pna_jk.PNA_JK(J_pna_jk.PNAJKConfig(**kw)), PNA_JK(PNAJKConfig(**kw))


def _trainers(sbm, name, **tkw):
    """The JAX and port trainers of one configuration, the same weights,
    before their fills."""
    data, in_c, out_c = sbm
    jm, pm = _models(name, data, in_c, out_c)
    kw = dict(num_parts=4, batch_size=1, seed=0, epochs=1, **tkw)
    jt = JTrainer(jm, data, JTrainerConfig(**kw))
    load_params(pm, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    return jt, Trainer(pm, _port_data(data), TrainerConfig(**kw), "cpu")


def _state(tr):
    return [t.clone() for t in (tr.out_table, *tr.hist.emb, *tr.hist.emb_ag)]


def _assert_matches_jax(jt, pt, atol=ATOL):
    """Logits and caches, the trash row left out (the JAX package's PNA_JK
    refresh writes padded rows there)."""
    n = pt.data.num_nodes
    np.testing.assert_allclose(pt.out_table[:n].numpy(), np.asarray(jt.out_table[:n]),
                               atol=atol, rtol=0, err_msg="logits")
    for kind in ("emb", "emb_ag"):
        for l, (a, b) in enumerate(zip(getattr(jt.hist, kind), getattr(pt.hist, kind))):
            np.testing.assert_allclose(b.float().numpy()[:n], np.asarray(a, np.float32)[:n],
                                       atol=atol, rtol=0, err_msg=f"{kind}[{l}]")


def _eager_twin(pt, **kw):
    """The port's ``scan=False`` refresh from zero caches and logits, the
    trainer's own state left as it was: ``(plan, [logits, *caches])``."""
    hist = type(pt.hist)([torch.zeros_like(t) for t in pt.hist.emb],
                         [torch.zeros_like(t) for t in pt.hist.emb_ag])
    _, out = pt.model.refresh(pt.tables.x, pt.eval_loader, hist, torch.zeros_like(pt.out_table),
                              vr=pt.cfg.vr_update, use_aggregation=pt.cfg.use_aggregation,
                              scan=False, **kw)
    return dict(pt.model._last_refresh_plan), [out, *hist.emb, *hist.emb_ag]


CASES = {
    "gcn-global-vr": ("gcn", "sbm_small", dict(adj_format="hybrid", vr_update=True)),
    "gcn2-global": ("gcn2", "sbm_small", dict(adj_format="hybrid")),
    "gcn-block-gas": ("gcn", "sbm_small", dict(adj_format="block")),
    "gat-hybrid": ("gat", "sbm_tiny", dict(adj_format="hybrid", loop=False, norm=False)),
    "pna-hybrid": ("pna", "sbm_tiny", dict(adj_format="hybrid", loop=False, norm=False)),
    "pna_jk": ("pna_jk", "sbm_tiny", dict(adj_format="hybrid", loop=False, norm=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scanned_fill_matches_jax(request, case):
    """The fills of both packages (``refresh`` with ``scan=True``), their
    plans, and the port's fill against its own ``scan=False`` sweep, bit
    for bit."""
    name, fixture, tkw = CASES[case]
    jt, pt = _trainers(request.getfixturevalue(fixture), name, **tkw)
    jt.fill_history()
    pt.fill_history()
    jplan, plan = jt.model._last_refresh_plan, pt.model._last_refresh_plan
    assert {k: plan[k] for k in KEYS} == {k: jplan[k] for k in KEYS}, (plan, jplan)
    assert plan["use_scan"] is (name != "pna_jk")
    assert plan["mechanism"] == ("eager" if name == "pna_jk" else "sweep")
    if "global" in case:
        assert plan["global_cols"]
    _assert_matches_jax(jt, pt)
    eager_plan, eager = _eager_twin(pt)
    assert eager_plan["mechanism"] == "eager" and not eager_plan["use_scan"]
    for got, want in zip(_state(pt), eager):
        assert torch.equal(got, want)


def test_refresh_frac_layers_match_jax(sbm_small):
    """``refresh_frac=0.5``: after the fill, two epochs each refresh a
    rotating half of the global-column batches through the ``layers``
    mechanism (their ``M_in[0]`` rows pushed per batch)."""
    jt, pt = _trainers(sbm_small, "gcn", adj_format="hybrid", vr_update=True,
                       refresh_frac=0.5)
    jt.fill_history()
    pt.fill_history()
    assert pt.model._last_refresh_plan["mechanism"] == "sweep"
    for _ in range(2):
        jt.train_epoch()
        pt.train_epoch()
        jt.evaluate()
        pt.evaluate()
        plan = pt.model._last_refresh_plan
        assert plan["mechanism"] == "layers" and plan["n_batches"] == 2
        assert plan["use_scan"] and plan["global_cols"]
    assert pt._refresh_cursor == jt._refresh_cursor == 0
    _assert_matches_jax(jt, pt, atol=5e-5)


@pytest.mark.parametrize("fmt", ["hybrid", "block"])
def test_host_held_layers_equal_the_eager_sweep(sbm_small, fmt):
    """An eval set held on the host (``device_cache=False``) is restaged
    for each layer into static buffers (``layers``), bit for bit the eager
    sweep's result; so is a ``subset`` of it."""
    data, in_c, out_c = sbm_small
    _, pm = _models("gcn2", data, in_c, out_c)
    pt = Trainer(pm, _port_data(data), TrainerConfig(num_parts=4, seed=0, adj_format=fmt,
                                                     vr_update=True), "cpu")
    pt.eval_loader.device_cache = False
    pt.fill_history()
    plan = pt.model._last_refresh_plan
    assert plan["mechanism"] == "layers" and plan["use_scan"] and not plan["on_device"]
    _, eager = _eager_twin(pt)
    for got, want in zip(_state(pt), eager):
        assert torch.equal(got, want)
    before = _state(pt)
    _, part = pt.model.refresh(pt.tables.x, pt.eval_loader, pt.hist, pt.out_table,
                               vr=True, subset=[2, 0])
    assert pt.model._last_refresh_plan["mechanism"] == "layers"
    hist = type(pt.hist)([t.clone() for t in before[1:3]], [t.clone() for t in before[3:]])
    _, want = pt.model.refresh(pt.tables.x, pt.eval_loader, hist, before[0].clone(),
                               vr=True, subset=[2, 0], scan=False)
    for got, ref in zip(_state(pt), [want, *hist.emb, *hist.emb_ag]):
        assert torch.equal(got, ref)


def test_chunked_budget_plan_matches_jax():
    """The JAX package's ``TestChunkedDeviceScanRefresh`` case: 70 batches
    held on the device and a budget of 3 batches.  Both packages scan (the
    set is on the device); JAX scans chunks of a stacked copy, the port's
    sweep reads the held batches in place."""
    data, in_c, out_c = make_sbm(num_nodes=2000, num_classes=4, num_features=8,
                                 avg_degree=6.0, seed=0)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=16,
               out_channels=out_c, num_layers=2, dropout=0.0, drop_input=False)
    kw = dict(num_parts=70, batch_size=1, seed=0, vr_update=True, epochs=1)
    jt = JTrainer(JGCN(JGCNConfig(**cfg)), data, JTrainerConfig(**kw))
    pm = GCN(GCNConfig(**cfg))
    load_params(pm, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    pt = Trainer(pm, _port_data(data), TrainerConfig(**kw), "cpu")
    jleaves = jax.tree_util.tree_leaves(next(iter(jt.eval_loader)).device)
    jt.model._refresh_hbm_budget = 3 * sum(int(np.prod(l.shape)) * l.dtype.itemsize
                                           for l in jleaves)
    held = pt.eval_loader.cached()
    pt.model._refresh_hbm_budget = 3 * sum(t.numel() * t.element_size()
                                           for t in _tensors(held[0].device))
    _, jhist, jout = jt.model.refresh(jt.params, jt.state, jt.tables.x, jt.eval_loader,
                                      jax.tree.map(jnp.zeros_like, jt.hist), None, vr=True)
    jt.hist, jt.out_table = jhist, jout
    pt.fill_history()
    jplan, plan = jt.model._last_refresh_plan, pt.model._last_refresh_plan
    assert {k: plan[k] for k in KEYS} == {k: jplan[k] for k in KEYS}, (plan, jplan)
    assert plan["n_batches"] == 70 and plan["use_scan"] and plan["on_device"]
    assert not jplan["resident"] and plan["resident"] and plan["mechanism"] == "sweep"
    _assert_matches_jax(jt, pt)
    _, eager = _eager_twin(pt)
    for got, want in zip(_state(pt), eager):
        assert torch.equal(got, want)


class _FakeGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    step it was captured from."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture
def fake_capture(monkeypatch):
    """The refresh's CUDA path on the CPU: captures made by
    :class:`_FakeGraph`, in the order the refresh makes them."""
    from incagg_gnn_tpu_torch.models import base

    calls = []

    def capture(step, generator=None, pool=None, keep_graph=False):
        calls.append(step)
        return _FakeGraph(step), {}

    monkeypatch.setattr(base, "graphs_on", lambda device: True)
    monkeypatch.setattr(base, "capture_graph", capture)
    monkeypatch.setattr(base.RefreshGraphs, "pool_handle", lambda self: None)
    return calls


def test_graph_warmups_captures_and_drops(sbm_small, fake_capture):
    """The bookkeeping of the captured refresh: the first refresh of a key
    is the eager warm-up, the second captures, later ones replay;
    ``full_forward`` neither reuses nor drops the trainer's graph;
    ``restore_checkpoint`` drops it and the next refresh captures anew with
    no warm-up; ``refresh_frac`` windows share one set of layer graphs.
    Every refresh equals its ``scan=False`` twin bit for bit."""
    data, in_c, out_c = sbm_small
    _, pm = _models("gcn", data, in_c, out_c)
    pt = Trainer(pm, _port_data(data), TrainerConfig(num_parts=4, seed=0, vr_update=True,
                                                     adj_format="hybrid"), "cpu")

    def refresh_matches(**kw):
        before = _state(pt)
        pt._refresh(host_logits=False)
        plan = dict(pt.model._last_refresh_plan)
        got = _state(pt)
        for dst, src in zip((pt.out_table, *pt.hist.emb, *pt.hist.emb_ag), before):
            dst.copy_(src)
        pt.model.refresh(pt.tables.x, pt.eval_loader, pt.hist, pt.out_table, vr=True,
                         scan=False, **kw)
        for a, b in zip(got, _state(pt)):
            assert torch.equal(a, b)
        return plan

    pt.fill_history()
    plan = pt.model._last_refresh_plan
    assert (plan["mechanism"], plan["warmup"], plan["captures"]) == ("sweep", True, 0)
    assert [(p["warmup"], p["captures"]) for p in (refresh_matches(), refresh_matches())] \
        == [(False, 1), (False, 1)]
    graph, plan = pt.model._refresh_graphs.sweep, dict(pt.model._last_refresh_plan)
    pt.full_forward(_port_data(data))
    assert pt.model._last_refresh_plan == plan and pt.model._refresh_graphs.sweep is graph
    assert refresh_matches()["captures"] == 1 and len(fake_capture) == 1
    pt.restore_checkpoint({k: v.clone() for k, v in pt.checkpoint_state().items()})
    assert pt.model._refresh_graphs.sweep is None
    plan = refresh_matches()
    assert (plan["warmup"], plan["captures"]) == (False, 2)

    pt.cfg.refresh_frac = 0.5  # windows [0, 1], [2, 3], ...
    plans = [refresh_matches(subset=[2 * (k % 2), 2 * (k % 2) + 1]) for k in range(4)]
    assert [(p["mechanism"], p["warmup"], p["captures"]) for p in plans] == [
        ("layers", True, 2), ("layers", False, 4), ("layers", False, 4), ("layers", False, 4)]
    assert len(fake_capture) == 4
