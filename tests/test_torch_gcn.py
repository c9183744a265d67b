"""The port's GCN against the JAX package's, with JAX-initialised
parameters carried over by ``convert.py`` and dropout 0: the GAS and VR
training forwards and the refresh sweep's logits and caches; atol 1e-4."""

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
from incagg_gnn_tpu.models.gcn import GCN as JGCN
from incagg_gnn_tpu.models.gcn import GCNConfig as JCfg
from incagg_gnn_tpu_torch.convert import load_gcn_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.history import HistoryState, pull, push, reset_trash_row
from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 1e-4

ARCH = dict(num_layers=3, hidden_channels=32, dropout=0.0, drop_input=False,
            batch_norm=True, residual=False)
LOADER = dict(adj_format="block", block_d_hint=32, block_force=True)


@pytest.fixture(scope="module")
def setup(sbm_small):
    data, in_c, out_c = sbm_small
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    data.adj_t = J_csr.gcn_norm(data.adj_t.set_diag())
    tdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    n = data.num_nodes
    jmodel = JGCN(JCfg(num_nodes=n, in_channels=in_c, out_channels=out_c, **ARCH))
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
    tmodel = GCN(GCNConfig(num_nodes=n, in_channels=in_c, out_channels=out_c, **ARCH))
    load_gcn_params(tmodel, params, state)
    x_table = np.concatenate([data.x, np.zeros((1, in_c), np.float32)])
    return dict(data=data, tdata=tdata, ptr=ptr, jmodel=jmodel, tmodel=tmodel,
                params=jax.tree.map(jnp.asarray, params),
                state=jax.tree.map(jnp.asarray, state), x_table=x_table, rng=rng)


def _random_tables(s, layers, dim):
    """Random cache tables with a zero trash row, as (JAX tuple, port list)."""
    n = s["data"].num_nodes
    tabs = []
    for _ in range(layers):
        t = s["rng"].standard_normal((n + 1, dim)).astype(np.float32)
        t[-1] = 0.0
        tabs.append(t)
    return tuple(jnp.asarray(t) for t in tabs), [torch.from_numpy(t.copy()) for t in tabs]


def _first_batches(s, mode):
    j = next(iter(JLoader(s["data"], s["ptr"], batch_size=2, mode=mode, **LOADER)))
    t = next(iter(SubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=2,
                                 mode=mode, **LOADER)))
    assert np.array_equal(np.asarray(j.device.n_id), t.device.n_id.numpy())
    return j, t


def _bn_stats_match(jstate, tmodel):
    for s, bn in zip(jstate["bns"], tmodel.bns):
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]),
                                   atol=ATOL, rtol=0)


def test_forward_gas_matches_jax(setup):
    s = setup
    jb, tb = _first_batches(s, "gas")
    m = s["tmodel"]
    jemb, temb = _random_tables(s, 3, m.hist_dim)
    x = s["x_table"][np.asarray(jb.device.n_id)]
    want, jstate, jemb_new, jmet = s["jmodel"].forward_gas(
        s["params"], s["state"], jnp.asarray(x), jb.device, jemb, None, True)
    got, tmet = m.forward_gas(torch.from_numpy(x), tb.device, temb, None, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for a, b in zip(jemb_new, temb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)
    _bn_stats_match(jstate, m)
    assert int(tmet["num_in_batch_neighbors"]) == int(jmet["num_in_batch_neighbors"])
    load_gcn_params(m, jax.tree.map(np.asarray, s["params"]),
                    jax.tree.map(np.asarray, s["state"]))


def test_forward_vr_matches_jax(setup):
    s = setup
    jb, tb = _first_batches(s, "ib")
    m = s["tmodel"]
    jemb, temb = _random_tables(s, 3, m.hist_dim)
    jag, tag = _random_tables(s, 3, m.hist_dim)
    x = s["x_table"][np.asarray(jb.device.n_id)]
    want, jstate, jmet = s["jmodel"].forward_vr(
        s["params"], s["state"], jnp.asarray(x), jb.device, JHist(jemb, jag), None, True)
    got, tmet = m.forward_vr(torch.from_numpy(x), tb.device, HistoryState(temb, tag),
                             None, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(tmet["drift"].detach()), float(jmet["drift"]), rtol=1e-5)
    _bn_stats_match(jstate, m)
    load_gcn_params(m, jax.tree.map(np.asarray, s["params"]),
                    jax.tree.map(np.asarray, s["state"]))


@pytest.mark.parametrize("vr", [False, True])
def test_refresh_matches_jax(setup, vr):
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
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip((*jhist.emb, *jhist.emb_ag), (*thist.emb, *thist.emb_ag)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_reset_trash_row_zeros_in_place():
    hist = HistoryState([torch.ones(5, 3)], [torch.ones(5, 3)])
    reset_trash_row(hist)
    for t in (*hist.emb, *hist.emb_ag):
        assert t[-1].abs().sum() == 0 and t[:-1].min() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn, torch.float8_e5m2])
def test_push_pull_cache_dtypes(dtype):
    """Pushes write in place in the cache dtype; pulls upcast to f32."""
    table = torch.zeros(6, 4, dtype=dtype)
    vals = torch.randn(2, 4, requires_grad=True)
    push(table, torch.tensor([1, 3]), vals)
    want = vals.detach().to(dtype).float()
    torch.testing.assert_close(pull(table, torch.tensor([1, 3])), want)
    assert table.dtype == dtype and table[[0, 2, 4, 5]].float().abs().sum() == 0
