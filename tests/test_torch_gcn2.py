"""The port's GCNII against the JAX package's, with JAX-initialised
parameters carried over by ``load_gcn2_params``, dropout 0 and BatchNorm on
with non-trivial statistics, for shared and unshared weights: the GAS and VR
training forwards and the refresh sweep's logits and caches (atol 1e-4), and
the first step's gradients after ``train_step`` (1e-5 relative); the CLI on
the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.history import HistoryState as JHist
from incagg_gnn_tpu.loader import EvalSubgraphLoader as JEval
from incagg_gnn_tpu.loader import SubgraphLoader as JLoader
from incagg_gnn_tpu.models.gcn2 import GCN2 as JGCN2
from incagg_gnn_tpu.models.gcn2 import GCN2Config as JCfg
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu_torch.__main__ import main as cli_main
from incagg_gnn_tpu_torch.convert import load_gcn2_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import gas_loss, train_step, vr_loss
from incagg_gnn_tpu_torch.train.tables import make_tables
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCH = dict(num_layers=3, hidden_channels=32, dropout=0.0, drop_input=False,
            batch_norm=True, residual=False, alpha=0.1, theta=0.5)
LOADER = dict(adj_format="block", block_d_hint=32, block_force=True)


@pytest.fixture(scope="module", params=[True, False], ids=["shared", "unshared"])
def setup(request, sbm_small):
    data, in_c, out_c = sbm_small
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    data.adj_t = J_csr.gcn_norm(data.adj_t.set_diag())
    tdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    n = data.num_nodes
    arch = dict(ARCH, shared_weights=request.param)
    jmodel = JGCN2(JCfg(num_nodes=n, in_channels=in_c, out_channels=out_c, **arch))
    params, state = jmodel.init(jax.random.PRNGKey(0))
    # non-trivial BatchNorm parameters and running statistics
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    for p, s in zip(params["bns"], state["bns"]):
        d = p["scale"].shape[0]
        p["scale"] = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
        p["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        s["mean"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        s["var"] = (0.5 + rng.random(d)).astype(np.float32)
    tmodel = GCN2(GCN2Config(num_nodes=n, in_channels=in_c, out_channels=out_c, **arch))
    assert (tmodel.convs[0].w2 is None) == request.param
    np_params, np_state = params, state
    load_gcn2_params(tmodel, np_params, np_state)
    x_table = np.concatenate([data.x, np.zeros((1, in_c), np.float32)])
    return dict(data=data, tdata=tdata, ptr=ptr, jmodel=jmodel, tmodel=tmodel,
                np_params=np_params, np_state=np_state,
                params=jax.tree.map(jnp.asarray, params),
                state=jax.tree.map(jnp.asarray, state), x_table=x_table, rng=rng)


def _reload(s):
    """Undo the BatchNorm statistics a training forward updated."""
    load_gcn2_params(s["tmodel"], s["np_params"], s["np_state"])


def _random_tables(s, layers, dim):
    """Random cache tables with a zero trash row (numpy)."""
    n = s["data"].num_nodes
    tabs = []
    for _ in range(layers):
        t = s["rng"].standard_normal((n + 1, dim)).astype(np.float32)
        t[-1] = 0.0
        tabs.append(t)
    return tabs


def _first_batches(s, mode):
    j = next(iter(JLoader(s["data"], s["ptr"], batch_size=2, mode=mode, **LOADER)))
    t = next(iter(SubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=2,
                                 mode=mode, **LOADER)))
    assert np.array_equal(np.asarray(j.device.n_id), t.device.n_id.numpy())
    return j, t


def _jax_step(s, vr):
    """The JAX reference of one training step on the first batch, from
    random caches: one jitted forward + backward, kept for the forward and
    the gradient tests of the same (weights, mode)."""
    key = "jax_vr" if vr else "jax_gas"
    if key in s:
        return s[key]
    jb, tb = _first_batches(s, "ib" if vr else "gas")
    emb = _random_tables(s, 3, s["tmodel"].hist_dim)
    ag = _random_tables(s, 3, s["tmodel"].hist_dim)
    x = s["x_table"][np.asarray(jb.device.n_id)]
    push = np.asarray(jb.device.push_idx)
    y = np.concatenate([s["data"].y, [0]]).astype(np.int32)[push]
    mask = (np.concatenate([s["data"].train_mask, [False]])[push]
            & (np.arange(push.shape[0]) < jb.device.batch_size))

    def loss_fn(p, batch, x, emb, ag):
        if vr:
            out, state, aux = s["jmodel"].forward_vr(p, s["state"], x, batch,
                                                     JHist(emb, ag), None, True)
            new_emb = emb
        else:
            out, state, new_emb, aux = s["jmodel"].forward_gas(
                p, s["state"], x, batch, emb, None, True)
        loss = j_masked_loss(out, jnp.asarray(y), jnp.asarray(mask), False)[0]
        return loss, (out, state, new_emb, aux)

    (loss, (out, state, new_emb, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        s["params"], jb.device, jnp.asarray(x), tuple(map(jnp.asarray, emb)),
        tuple(map(jnp.asarray, ag)))
    s[key] = dict(tb=tb, x=x, emb=emb, ag=ag, loss=float(loss), out=np.asarray(out),
                  state=jax.tree.map(np.asarray, state),
                  new_emb=[np.asarray(e) for e in new_emb],
                  aux=jax.tree.map(np.asarray, aux),
                  grads=jax.tree.map(np.asarray, grads))
    return s[key]


def _torch_tables(tabs):
    return [torch.from_numpy(t.copy()) for t in tabs]


def _bn_stats_match(jstate, tmodel):
    for s, bn in zip(jstate["bns"], tmodel.bns):
        np.testing.assert_allclose(bn.running_mean.numpy(), s["mean"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), s["var"], atol=ATOL, rtol=0)


def test_forward_gas_matches_jax(setup):
    """Logits, the caches pushed by layers 1..L-1 and BatchNorm statistics."""
    s = setup
    j = _jax_step(s, vr=False)
    m = s["tmodel"]
    temb = _torch_tables(j["emb"])
    got, tmet = m.forward_gas(torch.from_numpy(j["x"]), j["tb"].device, temb, None, True)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    for a, b in zip(j["new_emb"], temb):
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL, rtol=0)
    _bn_stats_match(j["state"], m)
    assert int(tmet["num_in_batch_neighbors"]) == int(j["aux"]["num_in_batch_neighbors"])
    _reload(s)


def test_forward_vr_matches_jax(setup):
    """Logits, drift and BatchNorm statistics."""
    s = setup
    j = _jax_step(s, vr=True)
    m = s["tmodel"]
    hist = HistoryState(_torch_tables(j["emb"]), _torch_tables(j["ag"]))
    got, tmet = m.forward_vr(torch.from_numpy(j["x"]), j["tb"].device, hist, None, True)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(tmet["drift"].detach()), float(j["aux"]["drift"]),
                               rtol=1e-5)
    _bn_stats_match(j["state"], m)
    _reload(s)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
def test_refresh_matches_jax(setup, vr):
    """Logits and every ``emb``/``emb_ag`` table of the sweep: layers 1 and 2
    read ``x0`` back from ``M_in[0]``."""
    s = setup
    m = s["tmodel"]
    jl = JEval(s["data"], s["ptr"], batch_size=1, adj_format="block-fwd",
               block_d_hint=32, block_force=True)
    tl = EvalSubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=1,
                            adj_format="block-fwd", block_d_hint=32, block_force=True)
    jhist = s["jmodel"].init_history()
    thist = m.init_history(torch.float32, "cpu")
    want, jhist, _ = s["jmodel"].refresh(s["params"], s["state"],
                                         jnp.asarray(s["x_table"]), jl, jhist, vr=vr)
    got, _ = m.refresh(torch.from_numpy(s["x_table"]), tl, thist, vr=vr)
    assert tl.dense_tiles() > 0
    assert float(thist.emb[0].abs().sum()) > 0  # x0 was cached in both modes
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip((*jhist.emb, *jhist.emb_ag), (*thist.emb, *thist.emb_ag)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
def test_first_step_grads_match_jax(setup, vr):
    """Loss and every parameter's gradient of one ``train_step`` on the first
    batch, from the same random caches: max error <= 1e-5 x max |JAX grad|
    per tensor."""
    s = setup
    j = _jax_step(s, vr)
    m = s["tmodel"]
    tables = make_tables(s["tdata"], "cpu")
    opt = Optimizer(m, m.reg_mask(), lr=0.01)
    temb = _torch_tables(j["emb"])
    if vr:
        hist = HistoryState(temb, _torch_tables(j["ag"]))
        loss, n, aux = vr_loss(m, j["tb"].device, tables, hist, None)
    else:
        loss, n, aux = gas_loss(m, j["tb"].device, tables, temb, None)
    metrics = train_step(opt, loss, n, aux)
    np.testing.assert_allclose(float(metrics["loss"]), j["loss"], rtol=1e-5)
    for name, p in m.named_parameters():
        group, i, leaf = name.split(".")
        want = j["grads"][group][int(i)][leaf]
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    _reload(s)


def test_reg_mask_regularizes_convs_and_bns(setup):
    mask = setup["tmodel"].reg_mask()
    assert mask and all(v == (not k.startswith("lins.")) for k, v in mask.items())
    assert any(k.startswith("convs.") for k in mask)


@pytest.mark.parametrize("vr", ["false", "true"], ids=["gas", "vr"])
def test_cli_trains_gcn2_on_cpu(monkeypatch, vr):
    monkeypatch.chdir(ROOT)
    argv = ["--model", "conf/model/gcn2.yaml", "--dataset", "sbm-small",
            "epochs=1", f"vr_update={vr}"]
    res = cli_main(argv + ["--device", "cpu"])
    ep = res["epochs"][0]
    assert ep["steps"] > 0 and np.isfinite(ep["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main(argv)
