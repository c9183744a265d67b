"""The port's APPNP against the JAX package's, with JAX-initialised
parameters carried over by ``load_appnp_params`` and dropout 0, on the
block, hybrid and COO formats: the GAS forward (all edges, and in-batch
edges only on the slot-exact formats), the VR forward and the refresh
sweep's logits and caches (atol 1e-4; the layers after 0 read ``x0`` back
from ``M_in[0]``), and the first step's gradients after ``train_step``
(1e-5 of the largest gradient); the CLI on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.loader import EvalSubgraphLoader as JEval
from incagg_gnn_tpu.models.appnp import APPNP as JAPPNP
from incagg_gnn_tpu.models.appnp import APPNPConfig as JCfg
from incagg_gnn_tpu_torch.__main__ import main as cli_main
from incagg_gnn_tpu_torch.convert import load_appnp_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader
from incagg_gnn_tpu_torch.models.appnp import APPNP, APPNPConfig
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import gas_loss, train_step, vr_loss
from incagg_gnn_tpu_torch.train.tables import make_tables
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)
from test_torch_sage import EVAL, _jax_step, _leaf, _reload, _tables

torch.set_num_threads(2)
ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(num_layers=3, hidden_channels=32, alpha=0.2, dropout=0.0)


@pytest.fixture(scope="module")
def setup(sbm_small):
    """sbm_small through APPNP's pipeline (``conf/model/appnp.yaml``: no
    self-loops, gcn-normalized)."""
    data, in_c, out_c = sbm_small
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    data.adj_t = J_csr.gcn_norm(data.adj_t, add_self_loops=False)
    tdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    jmodel = JAPPNP(JCfg(**cfg))
    params, state = jmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    tmodel = APPNP(APPNPConfig(**cfg))
    assert tmodel.hist_dim == jmodel.hist_dim == out_c
    load_appnp_params(tmodel, params)
    x_table = np.concatenate([data.x, np.zeros((1, in_c), np.float32)])
    return dict(data=data, tdata=tdata, ptr=ptr, jmodel=jmodel, tmodel=tmodel,
                load=lambda: load_appnp_params(tmodel, params),
                params=jax.tree.map(jnp.asarray, params), state=state,
                x_table=x_table, rng=np.random.default_rng(5))


@pytest.mark.parametrize("fmt,combined", [
    ("block", True), ("hybrid", True), ("hybrid", False), ("coo", True), ("coo", False)])
def test_forward_gas_matches_jax(setup, fmt, combined):
    """Logits, the caches pushed by propagations 0 and 1, the edge counts."""
    s = setup
    j = _jax_step(s, fmt, False, combined)
    temb = _tables(j["emb"])
    got, met = s["tmodel"].forward_gas(torch.from_numpy(j["x"]), j["tb"].device, temb,
                                       None, True, aggregate_combined=combined)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    for a, b in zip(j["new_emb"], temb):
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL, rtol=0)
    for k in ("num_in_batch_neighbors", "num_out_batch_neighbors"):
        assert int(met[k]) == int(j["aux"][k])


@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_forward_vr_matches_jax(setup, fmt):
    """Logits and drift of ``(1−α)(A_ib (x − M_in) + M_ag) + α x0``."""
    s = setup
    j = _jax_step(s, fmt, True)
    hist = HistoryState(_tables(j["emb"]), _tables(j["ag"]))
    got, met = s["tmodel"].forward_vr(torch.from_numpy(j["x"]), j["tb"].device, hist,
                                      None, True)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(met["drift"].detach()), float(j["aux"]["drift"]),
                               rtol=1e-5)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_refresh_matches_jax(setup, fmt, vr):
    """Logits and every ``emb``/``emb_ag`` table of the sweep; ``M_in[0]``
    holds the MLP output in both modes."""
    s = setup
    m = s["tmodel"]
    jl = JEval(s["data"], s["ptr"], batch_size=1, **EVAL[fmt])
    tl = EvalSubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=1, **EVAL[fmt])
    jhist = s["jmodel"].init_history()
    thist = m.init_history(torch.float32, "cpu")
    want, jhist, _ = s["jmodel"].refresh(s["params"], s["state"],
                                         jnp.asarray(s["x_table"]), jl, jhist, vr=vr)
    got, _ = m.refresh(torch.from_numpy(s["x_table"]), tl, thist, vr=vr)
    if fmt == "block":
        assert tl.dense_tiles() > 0
    assert float(thist.emb[0].abs().sum()) > 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip((*jhist.emb, *jhist.emb_ag), (*thist.emb, *thist.emb_ag)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_first_step_grads_match_jax(setup, fmt, vr):
    """Loss and both linears' gradients of one ``train_step`` on the first
    batch, from the same random caches: max error <= 1e-5 x the largest
    JAX gradient."""
    s = setup
    _reload(s)
    j = _jax_step(s, fmt, vr)
    m = s["tmodel"]
    tables = make_tables(s["tdata"], "cpu")
    opt = Optimizer(m, m.reg_mask(), lr=0.01)
    temb = _tables(j["emb"])
    if vr:
        loss, n, aux = vr_loss(m, j["tb"].device, tables,
                               HistoryState(temb, _tables(j["ag"])), None)
    else:
        loss, n, aux = gas_loss(m, j["tb"].device, tables, temb, None)
    metrics = train_step(opt, loss, n, aux)
    np.testing.assert_allclose(float(metrics["loss"]), j["loss"], rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(j["grads"]))
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _leaf(j["grads"], name), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    _reload(s)


def test_reg_mask_regularizes_the_first_linear(setup):
    mask = setup["tmodel"].reg_mask()
    assert mask == {"lins.0.w": True, "lins.0.b": True,
                    "lins.1.w": False, "lins.1.b": False}


@pytest.mark.parametrize("extra", [["vr_update=true"], ["edge_dropout=0.3"]],
                         ids=["vr", "edge-dropout"])
def test_cli_trains_appnp_on_cpu(monkeypatch, extra):
    """The CLI on sbm-small, Reverb/VR and GAS with edge dropout (COO)."""
    monkeypatch.chdir(ROOT)
    res = cli_main(["--model", "conf/model/appnp.yaml", "--dataset", "sbm-small",
                    "--device", "cpu", "epochs=1", *extra])
    ep = res["epochs"][0]
    assert ep["steps"] > 0 and np.isfinite(ep["loss"])
