"""The port's global-column refresh (the eval loader's ``global_cols``,
``models/base.py::_refresh_batch_global``, kernel B's storage-dtype form
through its plain version) against the JAX package's global-column fill,
on sbm_small with the trainers' hybrid format in Reverb/VR mode, 2 layers,
hidden 16, the same weights: GCN, GCNII, APPNP and GraphSAGE.  At f32 the
logits and every ``emb``/``emb_ag`` row but the trash row agree within
2e-5 (the JAX package's own bound between its global and batch-local
sweeps, ``tests/test_trainer_features.py``), also for a ``refresh_frac``
subset after a training epoch.  With bf16 and fp8 caches the tolerance is
the JAX fill's own error ``e_jax``, its largest distance from its f32-cache
fill: both packages round the same cache rows, but the JAX step also
rounds the adjacency values and the products to the cache dtype, where the
port sums in f32; so the port's fill must lie no farther from the f32 fill
(``e_port <= e_jax``; GCNII: bf16 4.0e-4 against 1.5e-3, e4m3 5.7e-3
against 3.6e-2, e5m2 1.3e-2 against 0.18, on logits up to 0.45) and within
``e_jax + e_port + 2e-5`` of the JAX fill.  GAT and PNA (not of the
sum/mean family), and the spill tier, refresh batch-locally."""

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import (
    APPNP as JAPPNP, APPNPConfig as JAPPNPConfig, GCN as JGCN, GCN2 as JGCN2,
    GCN2Config as JGCN2Config, GCNConfig as JGCNConfig, GraphSAGE as JSAGE,
    SAGEConfig as JSAGEConfig)
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.appnp import APPNP, APPNPConfig
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE, SAGEConfig
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _models(name, data, in_c, out_c):
    """(JAX model, port model) of the JAX package's own global-column
    test configurations (tests/test_trainer_features.py)."""
    common = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                  num_layers=2, dropout=0.0, hidden_channels=16)
    di = dict(drop_input=False)
    if name == "gcn":
        return JGCN(JGCNConfig(**common, **di)), GCN(GCNConfig(**common, **di))
    if name == "gcn2":
        kw = dict(common, **di, shared_weights=False, alpha=0.1, theta=0.5)
        return JGCN2(JGCN2Config(**kw)), GCN2(GCN2Config(**kw))
    if name == "appnp":
        return JAPPNP(JAPPNPConfig(**common, alpha=0.1)), APPNP(APPNPConfig(**common, alpha=0.1))
    return JSAGE(JSAGEConfig(**common, **di)), GraphSAGE(SAGEConfig(**common, **di))


def _filled(sbm, name, fmt="hybrid", **tkw):
    """The JAX and port trainers of one configuration after their fills."""
    data, in_c, out_c = sbm
    jm, pm = _models(name, data, in_c, out_c)
    kw = dict(num_parts=8, batch_size=1, vr_update=True, seed=0, epochs=1,
              adj_format=fmt, **tkw)
    jt = JTrainer(jm, data, JTrainerConfig(**kw))
    load_params(pm, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    pt = Trainer(pm, _port_data(data), TrainerConfig(**kw), "cpu")
    jt.fill_history()
    pt.fill_history()
    return jt, pt


def _f32(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _assert_state(jt, pt, atol=2e-5):
    n = pt.data.num_nodes
    np.testing.assert_allclose(pt.out_table[:n].numpy(), np.asarray(jt.out_table[:n]),
                               atol=atol, rtol=0, err_msg="logits")
    for kind in ("emb", "emb_ag"):
        for l, (a, b) in enumerate(zip(getattr(jt.hist, kind), getattr(pt.hist, kind))):
            np.testing.assert_allclose(_f32(b)[:n], _f32(a)[:n], atol=atol, rtol=0,
                                       err_msg=f"{kind}[{l}]")


MODELS = ["gcn", "gcn2", "appnp", "sage"]


@pytest.mark.parametrize("name", MODELS)
def test_global_fill_matches_jax(sbm_small, name):
    jt, pt = _filled(sbm_small, name)
    assert pt.eval_loader.uses_global_cols and jt.eval_loader.uses_global_cols
    plan = pt.model._last_refresh_plan
    assert plan["global_cols"] is jt.model._last_refresh_plan["global_cols"] is True
    assert plan["n_batches"] == jt.model._last_refresh_plan["n_batches"]
    _assert_state(jt, pt)


@pytest.mark.parametrize("name", ["gcn", "appnp"])
def test_global_subset_refresh_matches_jax(sbm_small, name):
    """``refresh_frac``: after one training epoch, a rotating half of the
    batches is refreshed, their ``M_in[0]`` rows pushed per batch."""
    jt, pt = _filled(sbm_small, name, refresh_frac=0.5)
    for _ in range(2):
        jt.train_epoch()
        pt.train_epoch()
        jt.evaluate()
        pt.evaluate()
    assert pt._refresh_cursor == jt._refresh_cursor == 0
    _assert_state(jt, pt, atol=5e-5)


def test_global_plan_follows_the_format(sbm_small):
    """COO eval batches keep batch-local columns in both packages."""
    jt, pt = _filled(sbm_small, "gcn", fmt="coo")
    assert pt.model._last_refresh_plan["global_cols"] is False
    assert jt.model._last_refresh_plan["global_cols"] is False
    assert not pt.eval_loader.uses_global_cols


@pytest.mark.parametrize("name", ["GAT", "PNA", "spill"])
def test_batch_local_refresh_plans(sbm_tiny, name):
    """GAT's attention and PNA's max/min take the batch-local sweep on the
    hybrid format in both packages; the port's spill tier stages
    batch-local rows, so its eval loader collates no global columns (the
    JAX spill trainer's does, ROADMAP §3)."""
    from incagg_gnn_tpu.models import GAT as JGAT, GATConfig as JGATConfig
    from incagg_gnn_tpu.models import PNA as JPNA, PNAConfig as JPNAConfig
    from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
    from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
    from incagg_gnn_tpu_torch.train.spill_trainer import SpillVRTrainer

    data, in_c, out_c = sbm_tiny
    common = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                  num_layers=2, dropout=0.0, hidden_channels=8)
    kw = dict(num_parts=4, batch_size=1, seed=0, adj_format="hybrid")
    if name == "spill":
        pt = SpillVRTrainer(GCN(GCNConfig(**common)), _port_data(data),
                            TrainerConfig(**kw, vr_update=True), "cpu")
        pt.fill_history()
        assert not pt.eval_loader.global_cols and not pt.eval_loader.uses_global_cols
        return
    if name == "GAT":
        jm, pm = JGAT(JGATConfig(**common, hidden_heads=2)), GAT(GATConfig(**common, hidden_heads=2))
    else:
        arch = dict(common, aggregators=("mean", "max"), scalers=("identity",))
        jm, pm = JPNA(JPNAConfig(**arch)), PNA(PNAConfig(**arch))
    jt = JTrainer(jm, data, JTrainerConfig(**kw, loop=False, norm=False))
    load_params(pm, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    pt = Trainer(pm, _port_data(data), TrainerConfig(**kw, loop=False, norm=False), "cpu")
    jt.fill_history()
    pt.fill_history()
    assert pt.model._last_refresh_plan["global_cols"] is False
    assert jt.model._last_refresh_plan["global_cols"] is False


@pytest.mark.parametrize("hist_dtype,torch_dtype", [
    ("bfloat16", torch.bfloat16), ("float8_e4m3", torch.float8_e4m3fn),
    ("float8_e5m2", torch.float8_e5m2)])
def test_global_fill_low_precision_caches(sbm_small, hist_dtype, torch_dtype):
    jt32, pt32 = _filled(sbm_small, "gcn2")
    jt, pt = _filled(sbm_small, "gcn2", hist_dtype=hist_dtype)
    assert pt.hist.emb[1].dtype == torch_dtype
    n = pt.data.num_nodes
    ref = np.asarray(jt32.out_table[:n])
    e_jax = float(np.abs(np.asarray(jt.out_table[:n]) - ref).max())
    e_port = float(np.abs(pt.out_table[:n].numpy() - ref).max())
    gap = float(np.abs(pt.out_table[:n].numpy() - np.asarray(jt.out_table[:n])).max())
    assert e_jax > 0.0  # the caches did round
    assert e_port <= e_jax, (e_port, e_jax)
    assert gap <= e_jax + e_port + 2e-5, (gap, e_jax, e_port)
