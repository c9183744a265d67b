"""The port's COO aggregation (``ops/spmm.py``) against the JAX package's on
the CPU: the builder bit for bit; sum, mean, max, min, ``segment_softmax``,
``mask_in_batch`` and ``binarized`` with empty rows and padding edges
(atol 1e-5); the input gradients against ``jax.vjp`` (atol 1e-5); edge
dropout with the JAX package's keep mask fed in (exact); and the
aggregation front-end's COO dispatch and edge counts."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models.nn import edge_dropout as j_edge_dropout
from incagg_gnn_tpu.ops import agg as J_agg
from incagg_gnn_tpu_torch.models.nn import edge_dropout
from incagg_gnn_tpu_torch.ops import agg as T_agg
from incagg_gnn_tpu_torch.ops import spmm as T_spmm
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

# the JAX package's ops/__init__ binds the name ``spmm`` to the function
J_spmm = importlib.import_module("incagg_gnn_tpu.ops.spmm")
torch.set_num_threads(2)
ATOL = 1e-5
R, C, E_PAD = 200, 256, 2048


def _csr(seed=0, weighted=True):
    """A ``[R, C]`` block: rows of degree 0 to 15 (every fifth row empty,
    the last rows too), columns below ``C - 1`` (the last padded column is
    the trash column), weights in (0, 1]."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 16, R - 20)
    deg[::5] = 0
    deg = np.concatenate([deg, np.zeros(20, np.int64)])
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col = rng.integers(0, C - 1, int(rowptr[-1])).astype(np.int32)
    val = (rng.random(col.size).astype(np.float32) + 0.05) if weighted else None
    return rowptr, col, val


def _pair(seed=0, weighted=True):
    args = (*_csr(seed, weighted), R, C, E_PAD)
    return J_spmm.build_padded_adj(*args), T_spmm.build_padded_adj(*args)


def _x(seed, rows=C, d=12):
    x = np.random.default_rng(seed).standard_normal((rows, d)).astype(np.float32)
    x[-1] = 0.0  # the trash column's zero features
    return x


@pytest.mark.parametrize("weighted", [True, False])
def test_build_padded_adj_identical(weighted):
    j, t = _pair(weighted=weighted)
    assert j._fields == t._fields
    for name, a, b in zip(j._fields, j, t):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert t.num_rows == R and (t.deg == 0).sum() > 20
    assert (t.vals == 0).sum() > 0  # padding edges


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_reductions_and_grads_match_jax(reduce):
    """Output and input gradient of each reduction, through the
    front-end's dispatch (the same as ``ops/spmm.py``'s own); rows without
    neighbors give 0."""
    j, t = _pair()
    x, g = _x(1), np.random.default_rng(2).standard_normal((R, 12)).astype(np.float32)
    jadj = jax.tree.map(jnp.asarray, j)
    want, vjp = jax.vjp(lambda v: J_agg.spmm_reduce(jadj, v, reduce), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = T_agg.spmm_reduce(t.to("cpu"), xt, reduce)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=ATOL, rtol=0)
    assert not got[t.deg == 0].any()
    direct = T_spmm.spmm_reduce(t.to("cpu"), torch.from_numpy(x), reduce)
    assert torch.equal(direct, got.detach())


@pytest.mark.parametrize("op", ["mask_in_batch", "binarized"])
def test_masked_and_binarized_forms_match_jax(op):
    """``mask_in_batch(bs)`` (values and recounted degrees) and
    ``binarized()``, then the mean over them."""
    j, t = _pair(3)
    jadj = jax.tree.map(jnp.asarray, j)
    bs = 97
    jm = jadj.mask_in_batch(bs) if op == "mask_in_batch" else jadj.binarized()
    tm = t.to("cpu").mask_in_batch(bs) if op == "mask_in_batch" else t.to("cpu").binarized()
    for name in ("rows", "cols", "vals", "deg"):
        a, b = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    x = _x(4)
    np.testing.assert_allclose(T_spmm.spmm_mean(tm, torch.from_numpy(x)).numpy(),
                               np.asarray(J_spmm.spmm_mean(jm, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked):
    """Per-row softmax of [E, H] scores; masked edges weigh 0, rows with no
    valid edge and rows with no edge at all included."""
    j, t = _pair(5)
    scores = np.random.default_rng(6).standard_normal((E_PAD, 3)).astype(np.float32)
    valid = np.asarray(t.vals != 0) if masked else None
    if masked:
        valid[: int(t.deg[:3].sum())] = False  # rows 0-2: no valid edge
    want = J_spmm.segment_softmax(jnp.asarray(scores), jnp.asarray(j.rows), R,
                                  None if valid is None else jnp.asarray(valid))
    got = T_spmm.segment_softmax(torch.from_numpy(scores), torch.from_numpy(t.rows), R,
                                 None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("weighted", [True, False])
def test_edge_dropout_with_the_jax_keep_mask(weighted):
    """The JAX package's draw, fed in as the keep mask, gives the JAX
    values exactly; without a mask the port draws its own (about p
    dropped); identity out of training."""
    _, t = _pair(7, weighted)
    vals = torch.from_numpy(t.vals)
    p, key = 0.3, jax.random.PRNGKey(11)
    want = j_edge_dropout(key, jnp.asarray(t.vals), p, True, weighted)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - p, t.vals.shape)))
    got = edge_dropout(vals, p, True, None, weighted, keep=keep)
    assert np.array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    drawn = edge_dropout(vals, p, True, gen, weighted)
    real = vals != 0
    share = float(((drawn == 0) & real).sum() / real.sum())
    assert 0.2 < share < 0.4
    kept = real & (drawn != 0)
    scale = 1.0 / (1.0 - p) if weighted else 1.0
    torch.testing.assert_close(drawn[kept], vals[kept] * scale)
    assert edge_dropout(vals, p, False, gen, weighted) is vals


def test_edge_counts_match_jax():
    j, t = _pair(8)
    want = J_agg.edge_counts(jax.tree.map(jnp.asarray, j), 120)
    got = T_agg.edge_counts(t.to("cpu"), 120)
    assert [int(v) for v in got] == [int(v) for v in want]
