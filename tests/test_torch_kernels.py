"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``cuda``: each test skips (from the ``cuda`` fixture, at run time)
where no CUDA device is present.  Run on the GPU with
``pytest -m cuda tests/test_torch_kernels.py``.  Tolerance: max |kernel -
plain| <= 1e-5 * max |plain| (f32 sums in another order; bf16 x bf16
products are exact in f32).
"""

import numpy as np
import pytest
import torch

from incagg_gnn_tpu_torch.graph.csr import CSRGraph
from incagg_gnn_tpu_torch.ops import kernels as K
from incagg_gnn_tpu_torch.ops.agg import spmm
from incagg_gnn_tpu_torch.ops.block import BF16, build_bi_block_hybrid, build_block_hybrid
from incagg_gnn_tpu_torch.ops.ell import build_hybrid_adj

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _clustered(seed=0, n=1024, m=40000):
    """Edges concentrated in 256-node clusters, so dense tiles appear."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, m)
    col = (row // 256) * 256 + rng.integers(0, 256, m)
    far = rng.random(m) < 0.2
    col[far] = rng.integers(0, n, int(far.sum()))
    return CSRGraph.from_coo(row, col, n, rng.random(m).astype(np.float32))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("d", [40, 128, 256])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rb", [128, 256, 512])
def test_block_spmm_matches_plain(cuda, rb, bf16, d):
    g = _clustered()
    adj = build_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, thresh=20,
                             a_dtype=BF16 if bf16 else np.float32, rb_rows=rb)
    dense = adj.dense.to(cuda)
    x = torch.randn(1024, d, device=cuda).to(dense.vals.dtype)
    before = K.block_spmm.launches
    got = K.block_spmm(dense, x, 1024)
    assert K.block_spmm.launches == before + 1
    _close(got, K.block_spmm_reference(dense, x, 1024))


@pytest.mark.parametrize("d", [40, 256])
def test_block_spmm_incidence_lanes4(cuda, d):
    g = _clustered(seed=1)
    inc = build_hybrid_adj(g.rowptr, g.col, g.value, 1024, 1024, k=8,
                           ovf_inc=True).ovf_inc.to(cuda)
    v = torch.randn(inc.cols2.shape[0], d, device=cuda)
    _close(K.block_spmm(inc, v, 1024), K.block_spmm_reference(inc, v, 1024))


@pytest.mark.parametrize("d,offset,bf16", [
    (128, 0, False),  # vector path
    (128, 0, True),
    (300, 0, False),  # two 256-column warps, the second partly live
    (6, 0, False),  # D not a multiple of 4: scalar path
    (37, 0, True),
    (64, 1, False),  # x off a 16-byte boundary: scalar path
])
def test_block_spmm_row_lengths(cuda, d, offset, bf16):
    """Rows with no entry (written 0), with more than 32 entries (two
    coalesced loads of pairs) and with more than 1,024 entries, in the
    layout the builder makes; odd D and a misaligned x take the scalar
    path."""
    rng = np.random.default_rng(5)
    n = 2048
    row = rng.integers(0, n, 20000)
    row[(row % 7 == 0) | (row == 3)] = 1  # no edge in rows 0, 7, 14, ...
    row = np.concatenate([row, np.full(3000, 3), np.full(80, 5)])
    col = (row // 512) * 512 + rng.integers(0, 512, row.size)
    col[row == 3] = np.arange(3000) % n  # row 3: over 1,024 distinct cells
    g = CSRGraph.from_coo(row, col, n, rng.random(row.size).astype(np.float32))
    dense = build_block_hybrid(g.rowptr, g.col, g.value, n, n, thresh=4,
                               a_dtype=BF16 if bf16 else np.float32,
                               rb_rows=512).dense
    lens = np.diff(dense.rowptr)
    assert lens[0] == 0 and lens[5] > 32 and lens[3] > 1024
    dense = dense.to(cuda)
    x = torch.randn(n * d + offset, device=cuda)[offset:].reshape(n, d)
    x = x.to(dense.vals.dtype)
    got = K.block_spmm(dense, x, n)
    want = K.block_spmm_reference(dense, x, n)
    assert float(got[0].abs().max()) == 0.0
    _close(got, want)


@pytest.mark.parametrize("d,offset", [(256, 0), (128, 0), (40, 0), (6, 1)])
@pytest.mark.parametrize("k", [8, 16, 32])
def test_ell_spmm_matches_plain(cuda, k, d, offset):
    """Vector and scalar paths (``offset`` makes x start off a 16-byte
    boundary; D=6 is not a multiple of 4)."""
    g = _clustered(seed=2)
    hyb = build_hybrid_adj(g.rowptr, g.col, g.value, 1024, 1024, k=k).to(cuda)
    x = torch.randn(1024 + offset, d, device=cuda)[offset:]
    before = K.ell_spmm.launches
    got = K.ell_spmm(hyb.ell_cols, hyb.ell_vals, x)
    assert K.ell_spmm.launches == before + 1
    _close(got, K.ell_spmm_reference(hyb.ell_cols, hyb.ell_vals, x))


@pytest.mark.parametrize("r,k,d,offset", [
    (11776, 56, 128, 0),  # the products ELL shape: two rows per warp
    (11777, 57, 256, 0),  # odd R and K, one warp per row and 256 columns
    (65, 9, 300, 0),  # two 256-column chunks, the second partly live
    (333, 16, 128, 0),  # odd R, vector path
    (1, 5, 40, 0),  # one row, K not a multiple of 32
    (257, 40, 257, 0),  # odd D: scalar path; K over one 32-slot chunk
    (129, 8, 6, 0),  # D below one 128-column chunk, not a multiple of 4
    (100, 16, 256, 1),  # g off a 16-byte boundary: scalar path
    (64, 0, 40, 0),  # K = 0: zeros
])
def test_ell_reduce_matches_plain(cuda, r, k, d, offset):
    g = torch.randn(r * k * d + offset, device=cuda)[offset:].reshape(r, k, d)
    vals = torch.rand(r, k, device=cuda)
    before = K.ell_reduce.launches
    got = K.ell_reduce(g, vals)
    assert K.ell_reduce.launches == before + 1
    want = K.ell_reduce_reference(g, vals)
    assert got.shape == want.shape == (r, d)
    if k == 0:
        assert float(got.abs().max()) == 0.0
    else:
        _close(got, want)


def test_ell_reduce_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.randn(8, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        K.ell_reduce(g.half(), torch.rand(8, 4, device=cuda).half())
    with pytest.raises(ValueError):
        K.ell_reduce(g, torch.rand(8, 5, device=cuda))
    with pytest.raises(ValueError):
        K.ell_reduce(g.transpose(0, 1), torch.rand(4, 8, device=cuda))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    g = _clustered()
    hyb = build_hybrid_adj(g.rowptr, g.col, g.value, 1024, 1024, k=8).to(cuda)
    with pytest.raises(TypeError):
        K.ell_spmm(hyb.ell_cols, hyb.ell_vals, torch.randn(1024, 8, device=cuda).half())
    with pytest.raises(RuntimeError, match="forward-only"):
        K.ell_spmm(hyb.ell_cols, hyb.ell_vals,
                   torch.randn(1024, 8, device=cuda, requires_grad=True))
    dense = build_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, 20).dense.to(cuda)
    with pytest.raises(TypeError):
        K.block_spmm(dense, torch.randn(1024, 8, device=cuda).bfloat16(), 1024)
    with pytest.raises(ValueError):
        K.block_spmm(dense, torch.randn(1024, 8, device=cuda), 4096)


def test_bi_block_gradient_matches_cpu(cuda):
    """The training pair on the card: forward and the transpose backward
    (both through the kernels) against the CPU plain versions."""
    g = _clustered(seed=3)
    adj = build_bi_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, thresh=20)
    x = torch.randn(1024, 64)
    gout = torch.randn(1024, 64)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        out = spmm(adj.to(dev), xd)
        out.backward(gout.to(dev))
        outs.append((out.detach().cpu(), xd.grad.cpu()))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])
