"""The port's aggregation ops against the JAX package on the CPU: the plain
versions of kernels A, B and C, and ``spmm`` forward + input gradient on the
four block and hybrid formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.graph import relabel as J_rel
from incagg_gnn_tpu.ops import agg as J_agg
from incagg_gnn_tpu.ops import block as J_block
from incagg_gnn_tpu.ops import ell as J_ell
from incagg_gnn_tpu.ops.pallas_spmm import pallas_ell_reduce, pallas_spmm_ell_vmem
from incagg_gnn_tpu_torch.ops import agg as T_agg
from incagg_gnn_tpu_torch.ops import block as T_block
from incagg_gnn_tpu_torch.ops import ell as T_ell
from incagg_gnn_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch_csr(sbm, clusters=2):
    """A normalized, relabeled GAS batch of ``clusters`` clusters (dense
    128x128 blocks appear along the diagonal)."""
    data = sbm[0]
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    adj = J_csr.gcn_norm(data.adj_t.set_diag())
    idx = np.arange(ptr[0], ptr[clusters])
    rowptr, col, val, n_id = J_rel.relabel_one_hop(adj, idx)
    r_pad = -(-len(idx) // 128) * 128
    c_pad = -(-len(n_id) // 128) * 128
    return rowptr, col, val, r_pad, c_pad


def _skewed_csr(rng, n=6000, heavy=600):
    """Degree-4 rows plus ``heavy`` degree-60 rows: ELL extension levels and
    a large overflow."""
    deg = np.full(n, 4)
    deg[rng.choice(n, heavy, replace=False)] = 60
    row = np.repeat(np.arange(n), deg)
    col = rng.integers(0, n, row.size)
    return J_csr.CSRGraph.from_coo(row, col, n, rng.random(row.size).astype(np.float32),
                                   coalesce=False)


@pytest.mark.parametrize("rb,bf16,d", [(128, False, 32), (256, False, 40),
                                       (128, True, 32), (256, True, 40)])
def test_block_plain_matches_dense_call(sbm_small, rng, rb, bf16, d):
    """Kernel A's plain version vs the JAX ``_dense_call`` (its XLA
    reference on the CPU), lanes 8 (dense tier); atol 1e-5."""
    import ml_dtypes

    rowptr, col, val, r_pad, c_pad = _batch_csr(sbm_small)
    thresh = J_block.marginal_thresh(4, 4, 32, rb)
    j = J_block.build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh, rb_rows=rb,
                                   a_dtype=ml_dtypes.bfloat16 if bf16 else np.float32)
    t = T_block.build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh, rb_rows=rb,
                                   a_dtype=T_block.BF16 if bf16 else np.float32)
    x = rng.standard_normal((c_pad, d)).astype(np.float32)
    want = J_block._dense_call(to_jax(j.dense), jnp.asarray(x), r_pad)
    tdense = t.dense.to("cpu")
    got = K.block_spmm(tdense, torch.from_numpy(x).to(tdense.vals.dtype), r_pad)
    assert t.dense.bcols.shape[0] == 8 and (t.dense.vals != 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_block_plain_matches_dense_call_incidence(rng):
    """Lanes 4: the overflow-incidence tiles."""
    g = _skewed_csr(rng, n=2000, heavy=200)
    j = J_ell.build_hybrid_adj(g.rowptr, g.col, g.value, 2048, 2048, k=8, ovf_inc=True)
    t = T_ell.build_hybrid_adj(g.rowptr, g.col, g.value, 2048, 2048, k=8, ovf_inc=True)
    inc = t.ovf_inc.to("cpu")
    v = rng.standard_normal((inc.cols2.shape[0], 24)).astype(np.float32)
    want = J_block._dense_call(to_jax(j.ovf_inc), jnp.asarray(v), 2048)
    got = K.block_spmm(inc, torch.from_numpy(v), 2048)
    assert inc.bcols.shape[0] == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bf16", [False, True])
def test_block_plain_and_edge_counts_on_duplicate_edges(rng, bf16):
    """Uncoalesced input with repeated and cancelling edges: kernel A's
    plain version vs ``_dense_call`` and ``edge_counts`` vs the JAX
    package's (which counts ``a != 0`` over the dense tiles)."""
    import ml_dtypes

    n = 1024
    row = rng.integers(0, n, 20000)
    col = (row // 256) * 256 + rng.integers(0, 256, row.size)
    val = rng.integers(1, 64, row.size).astype(np.float32) / 64
    d = rng.choice(row.size, 2000, replace=False)
    g = J_csr.CSRGraph.from_coo(np.concatenate([row, row[d], row[d[:500]]]),
                                np.concatenate([col, col[d], col[d[:500]]]), n,
                                np.concatenate([val, val[d], -2 * val[d[:500]]]),
                                coalesce=False)
    args = (g.rowptr, g.col, g.value, n, n, 20)
    j = J_block.build_block_hybrid(*args, a_dtype=ml_dtypes.bfloat16 if bf16 else np.float32)
    t = T_block.build_block_hybrid(*args, a_dtype=T_block.BF16 if bf16 else np.float32)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    want = J_block._dense_call(to_jax(j.dense), jnp.asarray(x), n)
    tdense = t.dense.to("cpu")
    got = K.block_spmm(tdense, torch.from_numpy(x).to(tdense.vals.dtype), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for bs in (300, n):
        want_c = J_agg.edge_counts(to_jax(j), bs)
        got_c = T_agg.edge_counts(t.to("cpu"), bs)
        assert [int(v) for v in got_c] == [int(v) for v in want_c]


def test_ell_plain_matches_pallas_blueprint(rng):
    """Kernel B's plain version vs ``pallas_spmm_ell_vmem`` in interpret
    mode, as tests/test_pallas_spmm.py runs it; atol 1e-4 (that test's)."""
    n = 512
    g = J_csr.CSRGraph.from_coo(rng.integers(0, n, 4000), rng.integers(0, n, 4000), n,
                                rng.random(4000).astype(np.float32))
    hyb = T_ell.build_hybrid_adj(g.rowptr, g.col, g.value, n, n, k=16).to("cpu")
    x = rng.standard_normal((n, 128)).astype(np.float32)
    want = pallas_spmm_ell_vmem(jnp.asarray(hyb.ell_cols.numpy()),
                                jnp.asarray(hyb.ell_vals.numpy()), jnp.asarray(x),
                                block_rows=128, interpret=True)
    got = K.ell_spmm(hyb.ell_cols, hyb.ell_vals, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("d", [40, 128])
@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("r", [256, 200])
def test_ell_reduce_plain_matches_pallas(rng, r, k, d):
    """Kernel C's plain version vs ``pallas_ell_reduce`` in interpret mode;
    atol 1e-5.  The Pallas kernel needs ``R % 128 == 0``, so only its input
    is zero-padded; the port takes any R."""
    g = rng.standard_normal((r, k, d)).astype(np.float32)
    vals = rng.random((r, k)).astype(np.float32)
    r_pad = -(-r // 128) * 128
    g_pad = np.zeros((r_pad, k, d), np.float32)
    g_pad[:r] = g
    vals_pad = np.zeros((r_pad, k), np.float32)
    vals_pad[:r] = vals
    want = pallas_ell_reduce(jnp.asarray(g_pad), jnp.asarray(vals_pad),
                             block_rows=128, interpret=True)
    got = K.ell_reduce(torch.from_numpy(g), torch.from_numpy(vals))
    assert got.shape == (r, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:r], atol=1e-5, rtol=0)


def test_ell_reduce_plain_only_on_cpu(rng):
    """Kernel C's wrapper: the plain version on the CPU, no launch counted;
    no fallback on any other device."""
    g = torch.randn(5, 3, 7)
    vals = torch.rand(5, 3)
    before = K.ell_reduce.launches
    torch.testing.assert_close(K.ell_reduce(g, vals), K.ell_reduce_reference(g, vals))
    assert K.ell_reduce.launches == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        K.ell_reduce(g.to("meta"), vals.to("meta"))


def _formats(kind, sbm_small, rng):
    """(JAX adj, port adj, rows, cols) of one format."""
    if kind in ("hybrid", "bi_hybrid"):
        g = _skewed_csr(rng)
        n_pad = -(-g.num_nodes // 128) * 128
        args = (g.rowptr, g.col, g.value, n_pad, n_pad)
        if kind == "hybrid":
            kw = dict(bucket_ext=True, ovf_inc=True)
            j, t = J_ell.build_hybrid_adj(*args, **kw), T_ell.build_hybrid_adj(*args, **kw)
            assert t.ext and t.ovf_inc is not None
        else:
            kw = dict(k=8, k_t=16, ovf_pad=40960, ovf_pad_t=40960)
            j = J_ell.build_bi_hybrid_adj(*args, **kw)
            t = T_ell.build_bi_hybrid_adj(*args, **kw)
        return j, t, n_pad, n_pad
    rowptr, col, val, r_pad, c_pad = _batch_csr(sbm_small)
    thresh = J_block.marginal_thresh(4, 4, 32)
    args = (rowptr, col, val, r_pad, c_pad, thresh)
    if kind == "block":
        j, t = J_block.build_block_hybrid(*args), T_block.build_block_hybrid(*args)
    else:
        j, t = J_block.build_bi_block_hybrid(*args), T_block.build_bi_block_hybrid(*args)
    return j, t, r_pad, c_pad


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("kind", ["hybrid", "bi_hybrid", "block", "bi_block"])
def test_spmm_forward_and_grad_match_jax(sbm_small, rng, kind, mean):
    """``spmm``/``spmm_mean`` output and input gradient vs ``jax.vjp`` on
    all four formats; atol 1e-5."""
    j, t, rows, cols = _formats(kind, sbm_small, rng)
    d = 16
    x = rng.standard_normal((cols, d)).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    jfn = J_agg.spmm_mean if mean else J_agg.spmm
    tfn = T_agg.spmm_mean if mean else T_agg.spmm
    jadj = to_jax(j)
    want, vjp = jax.vjp(lambda v: jfn(jadj, v), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfn(t.to("cpu"), xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["hybrid", "bi_block", "block"])
def test_edge_counts_match_jax(sbm_small, rng, kind):
    j, t, rows, cols = _formats(kind, sbm_small, rng)
    bs = rows // 2
    want = J_agg.edge_counts(to_jax(j), bs)
    got = T_agg.edge_counts(t.to("cpu"), bs)
    assert [int(v) for v in got] == [int(v) for v in want]


def test_unported_format_raises():
    with pytest.raises(NotImplementedError, match="COO"):
        T_agg.spmm(object(), torch.zeros(1, 1))


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    """On the CPU the wrappers return the plain versions and count no
    launch; any other device without the kernel raises."""
    cols = torch.zeros(4, 8, dtype=torch.int32)
    vals = torch.ones(4, 8)
    x = torch.randn(16, 8)
    before = K.ell_spmm.launches
    torch.testing.assert_close(K.ell_spmm(cols, vals, x),
                               K.ell_spmm_reference(cols, vals, x))
    assert K.ell_spmm.launches == before
    with pytest.raises(RuntimeError, match="no kernel for device"):
        K.ell_spmm(cols.to("meta"), vals.to("meta"), x.to("meta"))


def test_binarized_and_cast_values_match_jax(rng):
    """``HybridAdj.binarized`` / ``cast_values`` on the device containers,
    extension levels and incidence tiles included."""
    g = _skewed_csr(rng)
    n_pad = -(-g.num_nodes // 128) * 128
    args = (g.rowptr, g.col, g.value, n_pad, n_pad)
    j = J_ell.build_hybrid_adj(*args, bucket_ext=True, ovf_inc=True)
    t = T_ell.build_hybrid_adj(*args, bucket_ext=True, ovf_inc=True).to("cpu")
    x = rng.standard_normal((n_pad, 8)).astype(np.float32)
    want = J_agg.spmm(to_jax(j).binarized(), jnp.asarray(x))
    got = T_agg.spmm(t.binarized(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    cast = t.cast_values(torch.bfloat16)
    assert cast.ell_vals.dtype == cast.ovf_inc.vals.dtype == torch.bfloat16
    assert all(e.vals.dtype == torch.bfloat16 for e in cast.ext)
    assert cast.ell_cols.dtype == torch.int32
