"""The port's GAT against the JAX package's on sbm_small, with
JAX-initialised parameters carried over by ``load_gat_params`` and dropout
0: the transpose slot permutation ``t2f`` and the ``with_perm`` builds bit
for bit (the native build, its numpy counterpart and the loader's
``adj_perm`` batches); the three conv forms (hybrid pair, forward-only
hybrid, COO) within 1e-4; the custom backward's gradients of ``w``,
``a_l``, ``a_r``, ``b`` and ``x`` within 1e-5 of the largest, without and
with equal explicit attention-dropout masks; one training epoch of the JAX
trainer and the port's (GAS and VR on hybrid, GAS on COO) within 1e-4;
kernel B's heads-form plain version against a loop of the one-head plain
version; and the CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.loader import EvalSubgraphLoader as JEval
from incagg_gnn_tpu.loader import SubgraphLoader as JLoader
from incagg_gnn_tpu.models import gat as J_gat
from incagg_gnn_tpu.ops import ell as J_ell
from incagg_gnn_tpu_torch.__main__ import main as cli_main
from incagg_gnn_tpu_torch.convert import load_gat_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
from incagg_gnn_tpu_torch.models import gat as T_gat
from incagg_gnn_tpu_torch.ops import ell as T_ell
from incagg_gnn_tpu_torch.ops import kernels as K
from test_torch_host import _skewed_csr, assert_same_tree
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)
from test_torch_sage import _host

torch.set_num_threads(2)
ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(num_layers=2, hidden_channels=8, hidden_heads=4, out_heads=1, dropout=0.0)
#: (JAX loader kwargs, port loader kwargs) of each batch form
FORMS = {"bi": dict(adj_format="hybrid", adj_perm=True),
         "hybrid": dict(adj_format="hybrid-fwd"),
         "coo": dict(adj_format="coo")}


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


@pytest.fixture(scope="module")
def setup(sbm_small):
    """sbm_small through GAT's pipeline (``conf/model/gat.yaml``: no
    self-loops, no normalization)."""
    data, in_c, out_c = sbm_small
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    jmodel = J_gat.GAT(J_gat.GATConfig(**cfg))
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    tmodel = T_gat.GAT(T_gat.GATConfig(**cfg))
    assert tmodel.hist_dim == jmodel.hist_dim == 32
    load_gat_params(tmodel, params)
    return dict(data=data, tdata=_port_data(data), ptr=ptr, jmodel=jmodel,
                tmodel=tmodel, params=params, rng=np.random.default_rng(7))


def _batches(s, form):
    """The first batch of ``form`` from the JAX and the port loader, the
    same arrays (``t2f`` included)."""
    key = ("batch", form)
    if key not in s:
        if form == "hybrid":
            jb = next(iter(JEval(s["data"], s["ptr"], batch_size=2, **FORMS[form])))
            tb = next(iter(EvalSubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=2,
                                              **FORMS[form])))
        else:
            jb = next(iter(JLoader(s["data"], s["ptr"], batch_size=2, **FORMS[form])))
            tb = next(iter(SubgraphLoader(s["tdata"], s["ptr"], "cpu", batch_size=2,
                                          **FORMS[form])))
        assert_same_tree(jb.device.adj, _host(tb.device.adj))
        s[key] = (jb.device, tb.device)
    return s[key]


# ---------------------------------------------------------------------------
# t2f and the builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [False, True])
def test_with_perm_build_identical(static):
    """The pair and its ``t2f`` bit for bit; the numpy permutation equals
    the native one; ``mask_in_batch`` and ``binarized`` keep ``t2f``."""
    rng = np.random.default_rng(3)
    g = _skewed_csr(rng, n=1000, heavy=100)
    args = (g.rowptr, g.col, g.value, 1024, 1152)
    kw = dict(k=16, k_t=16, ovf_pad=8192, ovf_pad_t=8192) if static else {}
    j = J_ell.build_bi_hybrid_adj(*args, with_perm=True, **kw)
    t = T_ell.build_bi_hybrid_adj(*args, with_perm=True, **kw)
    assert t.t2f is not None and (t.t2f >= 0).sum() == g.col.size
    assert_same_tree(j, t)
    k_fwd, k_t = t.fwd.ell_cols.shape[1], t.bwd.ell_cols.shape[1]
    np.testing.assert_array_equal(
        T_ell._transpose_perm_numpy(g.rowptr, g.col, k_fwd, 1024 * k_fwd, k_t, 1152,
                                    t.bwd.ovf_rows.shape[0]), t.t2f)
    dev = t.to("cpu")
    assert dev.t2f.dtype == torch.int32
    assert dev.mask_in_batch(500).t2f is dev.t2f and dev.binarized().t2f is dev.t2f


def test_with_perm_one_off_and_empty_builds_match_jax():
    """A one-off build (no static buckets, the widths from the cost model)
    and an empty block, whose permutation is the numpy one (all padding),
    equal the JAX package's, ``t2f`` included."""
    rng = np.random.default_rng(4)
    g = _skewed_csr(rng, n=3000, heavy=300)
    args = (g.rowptr, g.col, g.value, 3072, 3072)
    t = T_ell.build_bi_hybrid_adj(*args, with_perm=True)
    assert t.t2f is not None
    assert_same_tree(J_ell.build_bi_hybrid_adj(*args, with_perm=True), t)
    empty = (np.zeros(9, np.int64), g.col[:0], None, 128, 128)
    je = J_ell.build_bi_hybrid_adj(*empty, with_perm=True)
    te = T_ell.build_bi_hybrid_adj(*empty, with_perm=True)
    assert (te.t2f == -1).all()
    assert_same_tree(je, te)


def test_with_scaled_values_drops_the_incidence():
    rng = np.random.default_rng(3)
    g = _skewed_csr(rng, n=1000, heavy=100)
    args = (g.rowptr, g.col, g.value, 1024, 1024)
    j = J_ell.build_hybrid_adj(*args, k=8, ovf_inc=True)
    t = T_ell.build_hybrid_adj(*args, k=8, ovf_inc=True).to("cpu")
    assert t.ovf_inc is not None
    ve = rng.random(t.ell_vals.shape).astype(np.float32)
    vo = rng.random(t.ovf_vals.shape).astype(np.float32)
    js = j.with_scaled_values(jnp.asarray(ve), jnp.asarray(vo))
    ts = t.with_scaled_values(torch.from_numpy(ve), torch.from_numpy(vo))
    assert js.ovf_inc is None and ts.ovf_inc is None
    assert torch.equal(ts.ovf_ptr, t.ovf_ptr)
    assert_same_tree(js, _host(ts))


@pytest.mark.parametrize("form", ["bi", "coo"])
def test_loader_batches_match_jax(setup, form):
    """The training loader's first batch, ``adj_perm`` pairs with their
    ``t2f``; GAT's pairs have no extension levels."""
    jb, tb = _batches(setup, form)
    if form == "bi":
        assert tb.adj.t2f is not None and not tb.adj.fwd.ext


def test_heads_plain_version_is_a_loop_of_the_one_head_one():
    """``hybrid_spmm_heads_reference`` on ``[R, K, H]`` values equals the
    fused plain version run on each head's columns with its values."""
    rng = np.random.default_rng(3)
    g = _skewed_csr(rng, n=500, heavy=60)
    adj = T_ell.build_hybrid_adj(g.rowptr, g.col, g.value, 512, 512, k=8,
                                 ovf_pad=4096).to("cpu")
    heads, dh = 3, 5
    ve = torch.from_numpy(rng.random((*adj.ell_cols.shape, heads)).astype(np.float32))
    vo = torch.from_numpy(rng.random((adj.ovf_cols.shape[0], heads)).astype(np.float32))
    ve[..., 0][adj.ell_vals == 0] = 0.0
    x = torch.from_numpy(rng.standard_normal((512, heads * dh)).astype(np.float32))
    got = K.hybrid_spmm_heads(adj.ell_cols, ve, adj.ovf_ptr, adj.ovf_cols, vo, x)
    for h in range(heads):
        want = K.hybrid_spmm_reference(adj.ell_cols, ve[..., h].contiguous(), adj.ovf_ptr,
                                       adj.ovf_cols, vo[:, h].contiguous(),
                                       x[:, h * dh:(h + 1) * dh])
        torch.testing.assert_close(got[:, h * dh:(h + 1) * dh], want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the conv forms and the custom backward
# ---------------------------------------------------------------------------

def _x(s, batch):
    n = batch.n_id.shape[0]
    return s["rng"].standard_normal((n, s["data"].x.shape[1])).astype(np.float32)


@pytest.mark.parametrize("layer", [0, 1], ids=["concat", "mean"])
@pytest.mark.parametrize("form", ["bi", "hybrid", "coo"])
def test_conv_forward_matches_jax(setup, form, layer):
    """One conv (4 concatenated heads, or the last layer's mean of its one
    head) on the same batch and inputs, eval mode."""
    s = setup
    jb, tb = _batches(s, form)
    x = _x(s, jb)  # 32 features: the hidden width the last conv reads
    jp = jax.tree.map(jnp.asarray, s["params"]["convs"][layer])
    conv = s["tmodel"].convs[layer]
    concat = layer == 0
    want = jax.jit(lambda p, x, adj: J_gat.gat_conv(
        p, x, adj, conv.heads, conv.out_dim, concat, None, 0.0, False))(
            jp, jnp.asarray(x), jb.adj)
    with torch.no_grad():
        got = T_gat.gat_conv(conv, torch.from_numpy(x), tb.adj, concat, None, 0.0, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _jax_conv_masked(p, x, adj, heads, d, concat, drop_e, drop_o):
    """The JAX package's ``gat_conv_bi`` with explicit attention masks."""
    r_pad = adj.fwd.num_rows
    wx = jnp.dot(x, p["w"]).reshape(x.shape[0], heads, d)
    a_src = (wx * p["a_l"]).sum(-1)
    a_dst = (wx[:r_pad] * p["a_r"]).sum(-1)
    out = J_gat._att_block(adj, a_src, a_dst, wx, drop_e, drop_o)
    if concat:
        return out.reshape(r_pad, heads * d) + p["b"]
    return out.mean(axis=1) + p["b"].reshape(heads, d).mean(0)


@pytest.mark.parametrize("masked", [False, True], ids=["no-dropout", "equal-masks"])
@pytest.mark.parametrize("combined", [True, False], ids=["all-edges", "in-batch"])
def test_custom_backward_matches_jax(setup, masked, combined):
    """Gradients of ``Σ out · cot`` with respect to ``w``, ``a_l``,
    ``a_r``, ``b`` and ``x`` through the scatter-free backward, against
    the JAX package's custom VJP: max error <= 1e-5 of the largest."""
    s = setup
    jb, tb = _batches(s, "bi")
    jadj, tadj = jb.adj, tb.adj
    if not combined:
        jadj, tadj = jadj.mask_in_batch(jb.batch_size), tadj.mask_in_batch(tb.batch_size)
    conv = s["tmodel"].convs[0]
    heads, d = conv.heads, conv.out_dim
    x = _x(s, jb)
    r_pad, k = tadj.fwd.ell_cols.shape
    cot = s["rng"].standard_normal((r_pad, heads * d)).astype(np.float32)
    if masked:
        keep = 0.6
        drop_e = (s["rng"].random((r_pad, k, heads)) < keep).astype(np.float32) / keep
        drop_o = ((s["rng"].random((tadj.fwd.ovf_rows.shape[0], heads)) < keep)
                  .astype(np.float32) / keep)
    else:
        drop_e = np.ones((r_pad, k, heads), np.float32)
        drop_o = np.ones((tadj.fwd.ovf_rows.shape[0], heads), np.float32)

    def jloss(p, x):
        out = _jax_conv_masked(p, x, jadj, heads, d, True, jnp.asarray(drop_e),
                               jnp.asarray(drop_o))
        return (out * cot).sum()

    jp = jax.tree.map(jnp.asarray, s["params"]["convs"][0])
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    conv.zero_grad()
    drop = (torch.from_numpy(drop_e), torch.from_numpy(drop_o)) if masked else None
    out = T_gat.gat_conv_bi(conv, tx, tadj, True, None, 0.0, True, drop=drop)
    (out * torch.from_numpy(cot)).sum().backward()
    got = {**{n: p.grad.numpy() for n, p in conv.named_parameters()}, "x": tx.grad.numpy()}
    want = {**{n: np.asarray(v) for n, v in jgp.items()}, "x": np.asarray(jgx)}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name in ("w", "a_l", "a_r", "b", "x"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_load_gat_params_round_trip(setup):
    s = setup
    for conv, p in zip(s["tmodel"].convs, s["params"]["convs"]):
        for name in ("w", "a_l", "a_r", "b"):
            np.testing.assert_array_equal(getattr(conv, name).detach().numpy(), p[name])
    assert set(s["tmodel"].reg_mask().values()) == {True}
    with pytest.raises(ValueError, match="convs"):
        load_gat_params(s["tmodel"], {"convs": s["params"]["convs"][:1]})


# ---------------------------------------------------------------------------
# training epochs and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,vr", [("hybrid", False), ("hybrid", True), ("coo", False)],
                         ids=["hybrid-gas", "hybrid-vr", "coo-gas"])
def test_epoch_matches_jax(sbm_small, fmt, vr):
    """The fill's logits (atol 1e-4) and one epoch's loss (4 Adam steps from
    the same parameters, rtol 1e-4) of the JAX trainer and the port's."""
    from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
    from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig

    data, in_c, out_c = sbm_small
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    kw = dict(num_parts=8, batch_size=2, lr=0.01, epochs=1, seed=0, adj_format=fmt,
              vr_update=vr, loop=False, norm=False, fused_epoch="off")
    jt = JTrainer(J_gat.GAT(J_gat.GATConfig(**cfg)), data, JTrainerConfig(**kw))
    pt = Trainer(T_gat.GAT(T_gat.GATConfig(**cfg)), _port_data(data), TrainerConfig(**kw),
                 "cpu")
    load_gat_params(pt.model, jax.tree.map(np.asarray, jt.params))
    assert pt.train_loader.adj_perm == (fmt == "hybrid")
    np.testing.assert_allclose(pt.fill_history(), jt.fill_history(), atol=ATOL, rtol=0)
    want, got = jt.train_epoch(), pt.train_epoch()
    assert got["steps"] == want["steps"] == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


@pytest.mark.parametrize("extra,formats", [
    ([], ("hybrid", "hybrid-fwd")),
    (["vr_update=true"], ("hybrid", "hybrid-fwd")),
    (["adj_format=coo"], ("coo", "coo")),
    (["adj_format=coo", "vr_update=true"], ("coo", "coo")),
], ids=["gas", "vr", "coo-gas", "coo-vr"])
def test_cli_trains_gat_on_cpu(monkeypatch, extra, formats):
    """``auto`` trains GAT on the hybrid pair with its permutation, as the
    JAX trainer does at these batch sizes on the card (the port has no
    row-count gate); COO when asked."""
    monkeypatch.chdir(ROOT)
    res = cli_main(["--model", "conf/model/gat.yaml", "--dataset", "sbm-small",
                    "--device", "cpu", "epochs=1", *extra])
    ep = res["epochs"][0]
    assert res["formats"] == formats
    assert ep["steps"] > 0 and np.isfinite(ep["loss"]) and ep["val_acc"] > 0.2


def test_cli_refuses_block_for_gat(monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="block"):
        cli_main(["--model", "conf/model/gat.yaml", "--dataset", "sbm-small",
                  "--device", "cpu", "epochs=1", "adj_format=block"])
