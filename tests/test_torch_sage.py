"""The port's GraphSAGE against the JAX package's, with JAX-initialised
parameters carried over by ``load_sage_params``, dropout 0 and BatchNorm on
with non-trivial statistics, on the block, hybrid and COO formats: the GAS
forward (all edges, and in-batch edges only on the slot-exact formats), the
VR forward and the refresh sweep's logits and caches (atol 1e-4), and the
first step's gradients after ``train_step`` (1e-5 relative); and
``binarized()`` / ``mask_in_batch()`` of the adjacency formats, the dense
tiles rebuilt bit for bit by ``densify()``."""

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
from incagg_gnn_tpu.models.graphsage import GraphSAGE as JSAGE
from incagg_gnn_tpu.models.graphsage import SAGEConfig as JCfg
from incagg_gnn_tpu.ops import agg as J_agg
from incagg_gnn_tpu.ops import block as J_block
from incagg_gnn_tpu.ops import ell as J_ell
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu_torch.convert import load_sage_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE, SAGEConfig
from incagg_gnn_tpu_torch.ops import agg as T_agg
from incagg_gnn_tpu_torch.ops import block as T_block
from incagg_gnn_tpu_torch.ops import ell as T_ell
from incagg_gnn_tpu_torch.ops import kernels as K
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import gas_loss, train_step, vr_loss
from incagg_gnn_tpu_torch.train.tables import make_tables
from test_torch_host import _batch_csr, _skewed_csr, assert_same_tree
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 1e-4
# hidden 24 < 32 input features: the caches are 32 wide, layer 1 reads 24
ARCH = dict(num_layers=2, hidden_channels=24, dropout=0.0, drop_input=False,
            batch_norm=True, residual=False)
#: training loader kwargs per format (the eval loaders take the forward form)
FORMATS = {"block": dict(adj_format="block", block_d_hint=24, block_force=True),
           "hybrid": dict(adj_format="hybrid"), "coo": dict(adj_format="coo")}
EVAL = {"block": dict(adj_format="block-fwd", block_d_hint=24, block_force=True),
        "hybrid": dict(adj_format="hybrid-fwd"), "coo": dict(adj_format="coo")}


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
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    jmodel = JSAGE(JCfg(**cfg))
    params, state = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    for p, s in zip(params["bns"], state["bns"]):
        d = p["scale"].shape[0]
        p["scale"] = (1.0 + 0.2 * rng.standard_normal(d)).astype(np.float32)
        p["bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        s["mean"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
        s["var"] = (0.5 + rng.random(d)).astype(np.float32)
    tmodel = GraphSAGE(SAGEConfig(**cfg))
    assert tmodel.hist_dim == jmodel.hist_dim == 32
    load_sage_params(tmodel, params, state)
    x_table = np.concatenate([data.x, np.zeros((1, in_c), np.float32)])
    return dict(data=data, tdata=tdata, ptr=ptr, jmodel=jmodel, tmodel=tmodel,
                load=lambda: load_sage_params(tmodel, params, state),
                params=jax.tree.map(jnp.asarray, params),
                state=jax.tree.map(jnp.asarray, state), x_table=x_table, rng=rng)


def _reload(s):
    """Undo what a training step changed (parameters, BatchNorm statistics)."""
    s["load"]()


def _random_tables(s):
    """Random cache tables, one a layer, with a zero trash row (numpy)."""
    n, m = s["data"].num_nodes, s["tmodel"]
    tabs = []
    for _ in range(m.cfg.num_layers):
        t = s["rng"].standard_normal((n + 1, m.hist_dim)).astype(np.float32)
        t[-1] = 0.0
        tabs.append(t)
    return tabs


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


def _jax_step(s, fmt, vr, combined=True):
    """The JAX reference of one training step on the first batch of
    ``fmt``, from random caches (one jitted forward + backward), kept for
    the forward and the gradient tests."""
    key = (fmt, vr, combined)
    if key in s:
        return s[key]
    mode = "ib" if vr else "gas"
    jb = next(iter(JLoader(s["data"], s["ptr"], batch_size=2, mode=mode,
                           **FORMATS[fmt])))
    tb = next(iter(SubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=2,
                                  mode=mode, **FORMATS[fmt])))
    # the loaders' batches are the same, pad buckets included
    assert np.array_equal(np.asarray(jb.device.n_id), tb.device.n_id.numpy())
    assert_same_tree(jb.device.adj, _host(tb.device.adj))
    emb = _random_tables(s)
    ag = _random_tables(s)
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
                p, s["state"], x, batch, emb, None, True, combined)
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


def _tables(tabs):
    return [torch.from_numpy(t.copy()) for t in tabs]


def _bn_stats_match(jstate, tmodel):
    for st, bn in zip(jstate["bns"], tmodel.bns):
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("fmt,combined", [
    ("block", True), ("hybrid", True), ("hybrid", False), ("coo", True), ("coo", False)])
def test_forward_gas_matches_jax(setup, fmt, combined):
    """Logits, the cache pushed by layer 0, BatchNorm statistics and the
    edge counts; ``combined=False`` aggregates in-batch edges only."""
    s = setup
    _reload(s)
    j = _jax_step(s, fmt, False, combined)
    m = s["tmodel"]
    temb = _tables(j["emb"])
    got, met = m.forward_gas(torch.from_numpy(j["x"]), j["tb"].device, temb, None, True,
                             aggregate_combined=combined)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    for a, b in zip(j["new_emb"], temb):
        np.testing.assert_allclose(b.numpy(), a, atol=ATOL, rtol=0)
    _bn_stats_match(j["state"], m)
    for k in ("num_in_batch_neighbors", "num_out_batch_neighbors"):
        assert int(met[k]) == int(j["aux"][k])
    _reload(s)


@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_forward_vr_matches_jax(setup, fmt):
    """Logits, drift and BatchNorm statistics of the binary-mean VR rule."""
    s = setup
    _reload(s)
    j = _jax_step(s, fmt, True)
    m = s["tmodel"]
    hist = HistoryState(_tables(j["emb"]), _tables(j["ag"]))
    got, met = m.forward_vr(torch.from_numpy(j["x"]), j["tb"].device, hist, None, True)
    np.testing.assert_allclose(got.detach().numpy(), j["out"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(met["drift"].detach()), float(j["aux"]["drift"]),
                               rtol=1e-5)
    _bn_stats_match(j["state"], m)
    _reload(s)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_refresh_matches_jax(setup, fmt, vr):
    """Logits and every ``emb``/``emb_ag`` table of the sweep (``M_ag`` is
    the binary mean)."""
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
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for a, b in zip((*jhist.emb, *jhist.emb_ag), (*thist.emb, *thist.emb_ag)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


@pytest.mark.parametrize("vr", [False, True], ids=["gas", "vr"])
@pytest.mark.parametrize("fmt", ["block", "hybrid", "coo"])
def test_first_step_grads_match_jax(setup, fmt, vr):
    """Loss and every parameter's gradient of one ``train_step`` on the first
    batch, from the same random caches: max error <= 1e-5 x the largest
    JAX gradient (the bias of layer 0's ``lin_l`` has a gradient of zero up
    to rounding, as BatchNorm follows it; the last BatchNorm has none: no
    layer after the last conv normalizes)."""
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
        want = _leaf(j["grads"], name)
        if p.grad is None:
            assert name.startswith("bns.1.") and not want.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
    _reload(s)


def test_reg_mask_regularizes_all_but_the_last_conv(setup):
    mask = setup["tmodel"].reg_mask()
    assert mask["convs.0.lin_l.w"] and mask["convs.0.lin_r.w"] and mask["bns.1.scale"]
    assert not mask["convs.1.lin_l.w"] and not mask["convs.1.lin_l.b"]


# ---------------- binarized / mask_in_batch of the adjacency formats ----------------

def _host(tree):
    """A container of tensors back to the host form of the builders (numpy,
    bfloat16 as its uint16 bits)."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.view(torch.int16).numpy().view(np.uint16)
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return tree


def _formats(kind, sbm, rng, bf16=False):
    """JAX and port containers of one kind on a batch with dense tiles
    (block kinds) or on a skewed graph with extension levels and the
    incidence tiles (hybrid kinds)."""
    import ml_dtypes

    if kind.endswith("block"):
        rowptr, col, val, r_pad, c_pad = _batch_csr(sbm)
        args = (rowptr, col, val, r_pad, c_pad, J_block.marginal_thresh(4, 4, 32))
        ja = dict(a_dtype=ml_dtypes.bfloat16 if bf16 else np.float32)
        ta = dict(a_dtype=T_block.BF16 if bf16 else np.float32)
        if kind == "block":
            return (J_block.build_block_hybrid(*args, **ja),
                    T_block.build_block_hybrid(*args, **ta), r_pad, c_pad)
        return (J_block.build_bi_block_hybrid(*args, **ja),
                T_block.build_bi_block_hybrid(*args, **ta), r_pad, c_pad)
    g = _skewed_csr(rng, n=6000, heavy=600)
    n_pad = -(-g.num_nodes // 128) * 128
    args = (g.rowptr, g.col, g.value, n_pad, n_pad)
    if kind == "hybrid":
        kw = dict(bucket_ext=True, ovf_inc=True)
        return (J_ell.build_hybrid_adj(*args, **kw), T_ell.build_hybrid_adj(*args, **kw),
                n_pad, n_pad)
    return (J_ell.build_bi_hybrid_adj(*args), T_ell.build_bi_hybrid_adj(*args),
            n_pad, n_pad)


def _same(j, t):
    """Field equality of a JAX container and a port container of tensors."""
    assert_same_tree(j, _host(t))


def _jax_adj(j):
    return jax.tree.map(jnp.asarray, j)


@pytest.mark.parametrize("kind,bf16", [("hybrid", False), ("bi_hybrid", False),
                                       ("block", False), ("block", True),
                                       ("bi_block", False)])
def test_binarized_matches_jax(sbm_small, rng, kind, bf16):
    """``binarized()`` field for field (values 0/1 in the value dtype; the
    tiles by ``densify()``, bit for bit), and the mean over it."""
    j, t, rows, cols = _formats(kind, sbm_small, rng, bf16)
    jb = _jax_adj(j).binarized()
    tb = t.to("cpu").binarized()
    _same(jb, tb)
    if bf16:
        assert tb.dense.vals.dtype == torch.bfloat16
        return
    x = rng.standard_normal((cols, 8)).astype(np.float32)
    want = J_agg.spmm_mean(jb, jnp.asarray(x))
    got = T_agg.spmm_mean(tb, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["hybrid", "bi_hybrid"])
def test_mask_in_batch_matches_jax(sbm_small, rng, kind):
    """``mask_in_batch`` (the forward's columns, the transpose's rows,
    recounted degrees, extension levels and incidence entries included):
    fields equal the JAX package's; the mean and its input gradient equal
    ``jax.vjp``'s; the overflow row pointer still covers the real entries,
    so the fused kernel B's plain version over the masked table equals the
    JAX sum."""
    j, t, rows, cols = _formats(kind, sbm_small, rng)
    bs = rows // 3
    jm = _jax_adj(j).mask_in_batch(bs)
    tm = t.to("cpu").mask_in_batch(bs)
    _same(jm, tm)
    x = rng.standard_normal((cols, 8)).astype(np.float32)
    g = rng.standard_normal((rows, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: J_agg.spmm_mean(jm, v), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = T_agg.spmm_mean(tm, xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=0)
    if kind == "bi_hybrid":  # single-K tables: the fused call covers them
        h = tm.fwd
        assert int(h.ovf_ptr[-1]) > 0 and not h.ext and h.ovf_inc is None
        fused = K.hybrid_spmm(h.ell_cols, h.ell_vals, h.ovf_ptr, h.ovf_cols, h.ovf_vals,
                              torch.from_numpy(x))
        np.testing.assert_allclose(
            fused.numpy(), np.asarray(J_ell.spmm_hybrid(jm.fwd, jnp.asarray(x))),
            atol=1e-5, rtol=0)


def test_epoch_at_reddit_widths_matches_jax():
    """GraphSAGE at the widths of ``sbm-reddit-mid`` (602 features, 1024
    hidden, degree 100) on a 1,200-node graph: the fill's logits (atol
    1e-4) and one training epoch's loss (10 Adam steps from the same
    parameters, batches in each trainer's own shuffled order; rtol 1e-4,
    the steps compounding f32 rounding) against the JAX trainer."""
    from incagg_gnn_tpu.graph.datasets import make_sbm
    from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
    from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig

    data, in_c, out_c = make_sbm(num_nodes=1200, num_classes=41, num_features=602,
                                 avg_degree=100.0, seed=0)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
               num_layers=2, hidden_channels=1024, dropout=0.0, drop_input=False,
               batch_norm=False, residual=False)
    kw = dict(num_parts=10, batch_size=1, lr=0.01, epochs=1, seed=42, adj_format="hybrid")
    jt = JTrainer(JSAGE(JCfg(**cfg)), data, JTrainerConfig(**kw))
    tdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    pt = Trainer(GraphSAGE(SAGEConfig(**cfg)), tdata, TrainerConfig(**kw), "cpu")
    load_sage_params(pt.model, jax.tree.map(np.asarray, jt.params),
                     jax.tree.map(np.asarray, jt.state))
    np.testing.assert_allclose(pt.fill_history(), jt.fill_history(), atol=ATOL, rtol=0)
    want, got = jt.train_epoch(), pt.train_epoch()
    assert got["steps"] == want["steps"] == 10
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
