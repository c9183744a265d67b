"""The port's PNA and PNA_JK against the JAX package's, with JAX-initialised
parameters carried over by ``load_pna_params`` / ``load_pna_jk_params`` and
dropout 0: the hybrid max and min (the plain versions of kernel B's max
form) forward and tie counts exactly, with forced ties (relu'd inputs with
many zeros, duplicated x rows), rows of degree 0, an overflow tail and the
in-batch-only mask; their gradients through the transpose within 1e-5 of
the largest; ``pna_conv`` with all four aggregators and three scalers on the
hybrid pair, the forward-only hybrid and COO within 1e-4, and its gradients
within 1e-5; the parameter loaders; the CLI and its ``block`` refusal.
``test_torch_pna_train.py`` holds the training epochs against the JAX
trainer."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.models import pna as J_pna
from incagg_gnn_tpu.models import pna_jk as J_pna_jk
from incagg_gnn_tpu.ops import agg as J_agg
from incagg_gnn_tpu.ops import ell as J_ell
from incagg_gnn_tpu.ops.spmm import build_padded_adj as j_build_padded_adj
from incagg_gnn_tpu_torch.__main__ import main as cli_main
from incagg_gnn_tpu_torch.convert import load_pna_jk_params, load_pna_params
from incagg_gnn_tpu_torch.models import pna as T_pna
from incagg_gnn_tpu_torch.models import pna_jk as T_pna_jk
from incagg_gnn_tpu_torch.ops import agg as T_agg
from incagg_gnn_tpu_torch.ops import ell as T_ell
from incagg_gnn_tpu_torch.ops import kernels as K
from incagg_gnn_tpu_torch.ops import spmm as T_spmm
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, C = 500, 700  # a batch's rows and columns
R_PAD, C_PAD = 512, 768
#: the full PNA conv at narrow widths: four aggregators x three scalers
FULL = dict(aggregators=("mean", "max", "min", "sum"),
            scalers=("identity", "amplification", "attenuation"),
            avg_deg_lin=4.1, avg_deg_log=1.3)


@pytest.fixture(scope="module")
def graph():
    """A bipartite batch block: rows of degree 0 to 5, every 40th row of
    degree 30 (an overflow tail at K = 8), columns drawn from 700 with
    columns 5 and 6 named by many rows (tails of the transpose), weights
    that binarization turns into ones."""
    rng = np.random.default_rng(11)
    deg = rng.integers(0, 6, R)
    deg[::40] = 30
    row = np.repeat(np.arange(R), deg)
    col = rng.integers(0, C, row.size)
    col[::9] = 5 + (row[::9] % 2)
    g = J_csr.CSRGraph.from_coo(row, col, R, rng.random(row.size).astype(np.float32) + 0.5)
    assert (np.diff(g.rowptr) == 0).any()
    return g


def _bi(g):
    args = (g.rowptr, g.col, g.value, R_PAD, C_PAD)
    kw = dict(k=8, k_t=8, ovf_pad=2048, ovf_pad_t=2048)
    j = J_ell.build_bi_hybrid_adj(*args, **kw).binarized()
    t = T_ell.build_bi_hybrid_adj(*args, **kw).to("cpu").binarized()
    assert int(t.fwd.ovf_ptr[-1]) > 0 and int(t.bwd.ovf_ptr[-1]) > 0
    return j, t


def _forms(g, form):
    """The JAX and port adjacency of ``form``, binarized."""
    if form == "bi":
        return _bi(g)
    args = (g.rowptr, g.col, g.value, R_PAD, C_PAD)
    if form == "hybrid":
        return (J_ell.build_hybrid_adj(*args, k=8, ovf_pad=2048).binarized(),
                T_ell.build_hybrid_adj(*args, k=8, ovf_pad=2048).to("cpu").binarized())
    e_pad = -(-g.col.size // 128) * 128
    return (j_build_padded_adj(*args, e_pad).binarized(),
            T_spmm.build_padded_adj(*args, e_pad).to("cpu").binarized())


def _tied_x(rng, d: int) -> np.ndarray:
    """relu of normals (about half zeros), every 7th row a copy of row 0."""
    x = np.maximum(rng.standard_normal((C_PAD, d)), 0.0).astype(np.float32)
    x[1::7] = x[0]
    x[C:] = 0.0
    return x


def _masked(j, t, combined: bool):
    return (j, t) if combined else (j.mask_in_batch(300), t.mask_in_batch(300))


# ---------------------------------------------------------------------------
# max / min on the hybrid formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combined", [True, False], ids=["all-edges", "in-batch"])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_hybrid_max_min_plain_matches_jax(graph, reduce, combined):
    """The forward-only hybrid max/min and the tie counts of the max form's
    plain version equal the JAX package's ``spmm_hybrid_max`` (min as
    ``-max(-x)``) and ``_max_tie_count`` bit for bit; ties, rows of
    degree 0 and overflow tails are all present."""
    jb, tb = _masked(*_bi(graph), combined)
    jadj, tadj = jb.fwd, tb.fwd
    x = _tied_x(np.random.default_rng(1), 24)
    got = T_agg.spmm_reduce(tadj, torch.from_numpy(x), reduce).numpy()
    want = np.asarray(J_agg.spmm_reduce(jadj, jnp.asarray(x), reduce))
    np.testing.assert_array_equal(got, want)
    xs = x if reduce == "max" else -x
    out, ties = K.hybrid_max_reference(tadj.ell_cols, tadj.ell_vals, tadj.ovf_ptr,
                                       tadj.ovf_cols, tadj.ovf_vals, tadj.deg,
                                       torch.from_numpy(xs), want_ties=True)
    np.testing.assert_array_equal(out.numpy(), got if reduce == "max" else -got)
    want_ties = np.asarray(J_ell._max_tie_count(jadj, jnp.asarray(xs), jnp.asarray(out.numpy())))
    np.testing.assert_array_equal(ties.numpy(), want_ties)
    empty = tadj.deg.numpy() == 0
    assert empty.any() and (ties.numpy() > 1).any()
    assert (out.numpy()[empty] == 0).all() and (ties.numpy()[empty] == 1).all()


@pytest.mark.parametrize("combined", [True, False], ids=["all-edges", "in-batch"])
@pytest.mark.parametrize("reduce", ["max", "min"])
def test_bi_max_min_gradient_matches_jax(graph, reduce, combined):
    """``spmm_bi_max`` / ``spmm_bi_min``: the forward bit for bit and the
    gradient of ``Σ out · cot`` (the scatter-free backward over the
    transpose, ties split evenly) within 1e-5 of the largest, against the
    JAX package's custom VJP."""
    jadj, tadj = _masked(*_bi(graph), combined)
    rng = np.random.default_rng(2)
    x = _tied_x(rng, 16)
    cot = rng.standard_normal((R_PAD, 16)).astype(np.float32)

    def jloss(x):
        return (J_agg.spmm_reduce(jadj, x, reduce) * cot).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    out = T_agg.spmm_reduce(tadj, tx, reduce)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(J_agg.spmm_reduce(jadj, jnp.asarray(x), reduce)))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_block_formats_refuse_max():
    """The dense tier has no max: ``TypeError``, as in the JAX package."""
    from incagg_gnn_tpu_torch.ops.block import build_bi_block_hybrid

    rng = np.random.default_rng(3)
    row = np.repeat(np.arange(256), 20)
    g = J_csr.CSRGraph.from_coo(row, rng.integers(0, 256, row.size), 256)
    adj = build_bi_block_hybrid(g.rowptr, g.col, g.value, 256, 256, thresh=4).to("cpu")
    for reduce in ("max", "min"):
        with pytest.raises(TypeError, match="dense tier"):
            T_agg.spmm_reduce(adj, torch.zeros(256, 4), reduce)


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------

def jax_pna_params(rng, dims, nb: int, jk_in: int = 0) -> dict:
    """Parameters in the JAX package's PNA layout (``{"convs": [{"pre":
    [{"w", "b"}] * nb, "post": [...], "lin": {...}}], "bns": [...]}``, and
    ``"jk"`` when ``jk_in``), drawn with numpy: uniform in ±sqrt(1/fan_in),
    as its ``linear_init`` draws them."""
    def lin(i, o):
        lim = np.sqrt(1.0 / i)
        return {"w": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
                "b": rng.uniform(-lim, lim, o).astype(np.float32)}

    params = {"convs": [{"pre": [lin(i, o) for _ in range(nb)],
                         "post": [lin(o, o) for _ in range(nb)], "lin": lin(i, o)}
                        for i, o in dims],
              "bns": [{"scale": np.ones(dims[0][1], np.float32),
                       "bias": np.zeros(dims[0][1], np.float32)}]}
    if jk_in:
        params["jk"] = lin(jk_in, dims[-1][1])
    return params


@pytest.fixture(scope="module")
def conv_models():
    """A 2-layer PNA (16 -> 8 -> 5) with all four aggregators and three
    scalers, parameters in the JAX layout loaded into the port's stacked
    one."""
    cfg = dict(num_nodes=C, in_channels=16, hidden_channels=8, out_channels=5,
               num_layers=2, **FULL)
    params = jax_pna_params(np.random.default_rng(0), [(16, 8), (8, 5)], 12)
    state = {"bns": [{"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}]}
    tmodel = T_pna.PNA(T_pna.PNAConfig(**cfg))
    load_pna_params(tmodel, params, state)
    return J_pna.PNAConfig(**cfg), params, tmodel


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("form", ["bi", "hybrid", "coo"])
def test_pna_conv_matches_jax(graph, conv_models, form, layer):
    """One PNAConv, 12 branches stacked into two aggregations, against the
    JAX package's branch-by-branch loop on the same adjacency and inputs:
    within 1e-4, plus 1e-6 of the value, since a row of degree 0 takes the
    attenuation scaler ``avg_log / (log 1 + 1e-5)``, about 1e5 times its
    post-linear bias, where f32 rounds in steps of ~0.004."""
    jcfg, params, tmodel = conv_models
    jadj, tadj = _forms(graph, form)
    d_in = 16 if layer == 0 else 8
    x = np.random.default_rng(4).standard_normal((C_PAD, d_in)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params["convs"][layer])
    want = J_pna.pna_conv(jp, jcfg, jnp.asarray(x), jadj)
    with torch.no_grad():
        got = T_pna.pna_conv(tmodel.convs[layer], torch.from_numpy(x), tadj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("combined", [True, False], ids=["all-edges", "in-batch"])
def test_pna_conv_gradient_matches_jax(graph, conv_models, combined):
    """Gradients of ``Σ conv(x) · cot`` over the hybrid pair with respect
    to every parameter (stacked back in the port's order) and ``x``,
    within 1e-5 of the largest."""
    jcfg, params, tmodel = conv_models
    jadj, tadj = _masked(*_bi(graph), combined)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((C_PAD, 16)).astype(np.float32)
    cot = rng.standard_normal((R_PAD, 8)).astype(np.float32)

    def jloss(p, x):
        return (J_pna.pna_conv(p, jcfg, x, jadj) * cot).sum()

    jp = jax.tree.map(jnp.asarray, params["convs"][0])
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    conv = tmodel.convs[0]
    conv.zero_grad()
    tx = torch.from_numpy(x).requires_grad_()
    (T_pna.pna_conv(conv, tx, tadj) * torch.from_numpy(cot)).sum().backward()
    jg = jax.tree.map(np.asarray, jgp)
    pre = [jg["pre"][i] for i in conv.order]
    post = [jg["post"][i] for i in conv.order]
    want = {"pre_w": np.concatenate([q["w"] for q in pre], 1),
            "pre_b": np.concatenate([q["b"] for q in pre]),
            "post_w": np.stack([q["w"] for q in post]),
            "post_b": np.stack([q["b"] for q in post]),
            "lin_w": jg["lin"]["w"], "lin_b": jg["lin"]["b"], "x": np.asarray(jgx)}
    got = {**{n: p.grad.numpy() for n, p in conv.named_parameters()}, "x": tx.grad.numpy()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-5 * scale, err_msg=name)


def test_load_pna_params_round_trip(conv_models):
    """Branch ``order[p]`` lands at stacked position ``p``: the sum and
    mean branches first, in the JAX order, then max and min; the last conv
    is not regularized; a depth mismatch raises."""
    jcfg, params, tmodel = conv_models
    conv = tmodel.convs[1]
    assert conv.order == [0, 1, 2, 9, 10, 11, 3, 4, 5, 6, 7, 8] and conv.n_lin == 6
    for p, i in enumerate(conv.order):
        q = params["convs"][1]
        np.testing.assert_array_equal(conv.pre_w[:, p * 5:(p + 1) * 5].detach().numpy(),
                                      q["pre"][i]["w"])
        np.testing.assert_array_equal(conv.post_b[p].detach().numpy(), q["post"][i]["b"])
    np.testing.assert_array_equal(conv.lin_w.detach().numpy(), params["convs"][1]["lin"]["w"])
    mask = tmodel.reg_mask()
    assert mask["convs.0.pre_w"] and not mask["convs.1.post_w"] and mask["bns.0.scale"]
    with pytest.raises(ValueError, match="convs"):
        load_pna_params(tmodel, {"convs": params["convs"][:1]}, {})


def test_load_pna_jk_params_round_trip():
    cfg = dict(num_nodes=C, in_channels=16, hidden_channels=8, out_channels=5,
               num_layers=3, **FULL)
    params, state = J_pna_jk.PNA_JK(J_pna_jk.PNAJKConfig(**cfg)).init(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    tmodel = T_pna_jk.PNA_JK(T_pna_jk.PNAJKConfig(**cfg))
    load_pna_jk_params(tmodel, params, state)
    np.testing.assert_array_equal(tmodel.jk.w.detach().numpy(), params["jk"]["w"])
    assert len(tmodel.bns) == 3 and tmodel.convs[2].out_dim == 8
    np.testing.assert_array_equal(tmodel.bns[2].running_var.numpy(), state["bns"][2]["var"])
    mask = tmodel.reg_mask()
    assert mask["convs.2.pre_w"] and not mask["jk.w"]
    with pytest.raises(NotImplementedError, match="true-VR"):
        T_pna_jk.PNA_JK(T_pna_jk.PNAJKConfig(**{**cfg, "true_vr": True}))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,formats", [
    ([], ("hybrid", "hybrid-fwd")),
    (["vr_update=true", "true_vr=true"], ("hybrid", "hybrid-fwd")),
    (["model=PNA_JK"], ("hybrid", "hybrid-fwd")),
    (["edge_dropout=0.2", "aggregate_combined=false"], ("coo", "hybrid-fwd")),
], ids=["gas", "vr-true", "jk-gas", "coo-edge-dropout"])
def test_cli_trains_pna_on_cpu(monkeypatch, extra, formats):
    """``auto`` trains PNA on the hybrid pair (COO under edge dropout), as
    the JAX trainer does; PNA_JK is the same YAML with ``model=PNA_JK``."""
    monkeypatch.chdir(ROOT)
    res = cli_main(["--model", "conf/model/pna.yaml", "--dataset", "sbm-small",
                    "--device", "cpu", "epochs=1", *extra])
    ep = res["epochs"][0]
    assert res["formats"] == formats
    assert ep["steps"] > 0 and np.isfinite(ep["loss"]) and ep["val_acc"] > 0.2


def test_cli_refuses_block_for_pna(monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="block"):
        cli_main(["--model", "conf/model/pna.yaml", "--dataset", "sbm-small",
                  "--device", "cpu", "epochs=1", "adj_format=block"])
