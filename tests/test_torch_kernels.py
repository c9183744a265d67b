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
from incagg_gnn_tpu_torch.ops.ell import build_bi_hybrid_adj, build_hybrid_adj

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


def _hybrid_pair(k, n=1001, seed=4):
    """A hybrid pair at odd R = C = 1001 with static buckets: at k = 8 over
    half of the ELL slots are padding, every 50th row has a tail of over 32
    entries, and the last row's real tail is followed by the overflow's
    padding entries (row R-1, weight 0); at k = 0 every edge is in a tail;
    at k = 80 no forward row has one."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n)
    deg[::50] = 70
    deg[-1] = 45
    row = np.repeat(np.arange(n), deg)
    g = CSRGraph.from_coo(row, rng.integers(0, n, row.size), n,
                          rng.random(row.size).astype(np.float32))
    adj = build_bi_hybrid_adj(g.rowptr, g.col, g.value, n, n, k=k, k_t=k,
                              ovf_pad=8192, ovf_pad_t=8192)
    f = adj.fwd
    if k >= 80:
        assert f.ovf_ptr[-1] == 0
        return adj
    assert f.ovf_ptr[-1] < f.ovf_rows.size and f.ovf_ptr[-1] > f.ovf_ptr[-2]
    assert np.diff(f.ovf_ptr).max() > 32
    if k:
        assert (f.ell_vals == 0).mean() >= 0.5
    return adj


@pytest.mark.parametrize("d,offset", [
    (4, 0), (40, 0), (64, 0),  # 1, 10 and 16 lanes a row: 32, 3 and 2 rows a warp
    (128, 0), (136, 0), (256, 0),  # one warp a row, one or two float4 a lane
    (300, 0),  # two 256-column chunks, the second partly live
    (6, 0), (64, 1),  # scalar path: D not a multiple of 4; x off 16 bytes
])
@pytest.mark.parametrize("k", [0, 8, 32])
def test_hybrid_spmm_matches_plain(cuda, k, d, offset):
    """The fused kernel B and the ELL core alone against their plain
    versions on both tables of a pair (forward and transpose)."""
    adj = _hybrid_pair(k).to(cuda)
    for h in (adj.fwd, adj.bwd):
        n_x = int(h.ell_cols.shape[0])
        x = torch.randn(n_x * d + offset, device=cuda)[offset:].reshape(n_x, d)
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        before = K.ell_spmm.launches, K.hybrid_spmm.launches
        got = K.hybrid_spmm(h.ell_cols, h.ell_vals, *tail, x)
        assert (K.ell_spmm.launches, K.hybrid_spmm.launches) == (before[0] + 1,
                                                                  before[1] + 1)
        _close(got, K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x))
        _close(K.ell_spmm(h.ell_cols, h.ell_vals, x),
               K.ell_spmm_reference(h.ell_cols, h.ell_vals, x))


TABLE_DTYPES = [torch.float32, torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2]


@pytest.mark.parametrize("d,offset", [
    (128, 0), (256, 0),  # f32 one warp a row; bf16, fp8 several rows a warp
    (1024, 0),  # f32 and bf16 in chunks of 64 pieces across blockIdx.y
    (40, 0),  # fp8 not a multiple of 16: scalar; bf16 5 lanes, f32 10 lanes a row
    (37, 0),  # odd D: the scalar path for every type
    (128, 1),  # the table off a 16-byte boundary: the scalar path
])
@pytest.mark.parametrize("dtype", TABLE_DTYPES, ids=lambda t: str(t).split(".")[-1])
@pytest.mark.parametrize("k", [0, 8], ids=["all-tail", "k8"])
def test_hybrid_spmm_table_matches_plain(cuda, k, dtype, d, offset):
    """Kernel B's storage-dtype form against its plain version (gather,
    upcast, sum) on the forward table of a pair, its rows' tails included
    (over 32 entries on every 50th row, padding after the last real one),
    with the table's rows in f32, bf16 and both fp8 types."""
    h = _hybrid_pair(k).fwd.to(cuda)
    n_x = int(h.ell_cols.shape[0])
    x = (torch.randn(n_x * d + offset, device=cuda) * 4).to(dtype)[offset:].reshape(n_x, d)
    tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
    before = K.launch_counts()
    got = K.hybrid_spmm_table(h.ell_cols, h.ell_vals, *tail, x)
    after = K.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {"hybrid_spmm_table": 1}
    assert got.dtype == torch.float32
    _close(got, K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x))


def test_hybrid_spmm_table_rejects_what_the_kernel_does_not_take(cuda):
    h = _hybrid_pair(8).fwd.to(cuda)
    tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
    x = torch.randn(h.ell_cols.shape[0], 64, device=cuda)
    with pytest.raises(TypeError, match="row type"):
        K.hybrid_spmm_table(h.ell_cols, h.ell_vals, *tail, x.half())
    with pytest.raises(TypeError, match="float32 only"):
        K.hybrid_spmm_table(h.ell_cols, h.ell_vals.bfloat16(), *tail, x)
    with pytest.raises(ValueError, match="contiguous"):
        K.hybrid_spmm_table(h.ell_cols, h.ell_vals, *tail, x.t().contiguous().t())


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
    x = torch.randn(1024, 8, device=cuda)
    with pytest.raises(ValueError):  # a pointer of the wrong length
        K.hybrid_spmm(hyb.ell_cols, hyb.ell_vals, hyb.ovf_ptr[:-1], hyb.ovf_cols,
                      hyb.ovf_vals, x)
    with pytest.raises(TypeError):
        K.hybrid_spmm(hyb.ell_cols, hyb.ell_vals, hyb.ovf_ptr.long(), hyb.ovf_cols,
                      hyb.ovf_vals, x)
    dense = build_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, 20).dense.to(cuda)
    with pytest.raises(TypeError):
        K.block_spmm(dense, torch.randn(1024, 8, device=cuda).bfloat16(), 1024)
    with pytest.raises(ValueError):
        K.block_spmm(dense, torch.randn(1024, 8, device=cuda), 4096)


def test_bi_hybrid_gradient_matches_cpu(cuda):
    """The hybrid training pair on the card: the forward and the transpose
    backward, each one fused launch, against the CPU plain versions."""
    adj = _hybrid_pair(8)
    x = torch.randn(1001, 40)
    gout = torch.randn(1001, 40)
    outs = []
    before = K.hybrid_spmm.launches
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        out = spmm(adj.to(dev), xd)
        out.backward(gout.to(dev))
        outs.append((out.detach().cpu(), xd.grad.cpu()))
    assert K.hybrid_spmm.launches == before + 2
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


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


def _reddit_like(seed=6, n=2048):
    """Degree 50 to 200 (about 125 on average, the reddit operating
    point's order), edges mostly inside 512-node clusters, gcn-like
    weights that the binarized tables replace by 1."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n), rng.integers(50, 200, n))
    col = (row // 512) * 512 + rng.integers(0, 512, row.size)
    far = rng.random(row.size) < 0.2
    col[far] = rng.integers(0, n, int(far.sum()))
    return CSRGraph.from_coo(row, col, n, rng.random(row.size).astype(np.float32))


@pytest.mark.parametrize("d", [602, 1024])
def test_block_spmm_binarized_at_reddit_widths(cuda, d):
    """Kernel A over binarized [512, 128] tiles (values 1.0) at GraphSAGE's
    widths: D602 takes the scalar path, D1024 four 256-column chunks; on
    the forward and the transposed tiles of a training pair."""
    g = _reddit_like()
    adj = build_bi_block_hybrid(g.rowptr, g.col, g.value, 2048, 2048, thresh=20,
                                rb_rows=512).to(cuda).binarized()
    x = torch.randn(2048, d, device=cuda)
    for dense in (adj.fwd.dense, adj.bwd.dense):
        assert bool((dense.vals == 1).all())
        before = K.block_spmm.launches
        got = K.block_spmm(dense, x, 2048)
        assert K.block_spmm.launches == before + 1
        _close(got, K.block_spmm_reference(dense, x, 2048))


@pytest.mark.parametrize("d", [602, 1024])
@pytest.mark.parametrize("k", [32, 128])
def test_hybrid_spmm_binarized_at_reddit_widths(cuda, k, d):
    """Kernel B fused with its overflow tail over binarized tables at
    degree ~125: K 32 (tails of up to 168 entries) and K 128 (most rows
    in the ELL slots); forward and transpose tables."""
    g = _reddit_like(seed=7)
    adj = build_bi_hybrid_adj(g.rowptr, g.col, g.value, 2048, 2048, k=k, k_t=k,
                              ovf_pad=1 << 18, ovf_pad_t=1 << 18).to(cuda).binarized()
    x = torch.randn(2048, d, device=cuda)
    for h in (adj.fwd, adj.bwd):
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        assert int(h.ovf_ptr[-1]) > 0
        got = K.hybrid_spmm(h.ell_cols, h.ell_vals, *tail, x)
        _close(got, K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x))


def _head_values(h, heads, rng):
    """Per-head values on a table's slots: random where the adjacency has
    an edge, zero on padding; in head 0 every third real slot is zero
    (attention dropout in one head only) and every seventh real slot is
    zero in all heads."""
    ve = rng.random((*h.ell_vals.shape, heads)).astype(np.float32) + 0.1
    ve[np.asarray(h.ell_vals) == 0] = 0.0
    vo = rng.random((h.ovf_vals.shape[0], heads)).astype(np.float32) + 0.1
    vo[np.asarray(h.ovf_vals) == 0] = 0.0
    for v in (ve.reshape(-1, heads), vo):
        v[::3, 0] = 0.0
        v[::7] = 0.0
    return torch.from_numpy(ve), torch.from_numpy(vo)


@pytest.mark.parametrize("heads,dh,offset", [
    (4, 64, 0),  # GAT's arxiv widths: one warp a row, two float4 a lane
    (4, 40, 0),  # D160: one warp a row, lanes past the width idle
    (1, 64, 0), (1, 40, 0),  # one head: the plain fused call
    (2, 16, 0),  # D32: 8 lanes a row, 4 rows a warp
    (8, 64, 0),  # D512: two 256-column chunks
    (2, 6, 0), (4, 64, 1),  # scalar path: Dh not a multiple of 4; x off 16 bytes
])
@pytest.mark.parametrize("k", [0, 8, 80], ids=["all-tail", "k8", "no-tail"])
def test_hybrid_spmm_heads_matches_plain(cuda, k, heads, dh, offset):
    """The heads form of kernel B on both tables of a pair against its
    plain version: each launch counted once in ``ell_spmm.launches`` and
    in ``hybrid_spmm.launches``."""
    adj = _hybrid_pair(k)
    rng = np.random.default_rng(heads * 100 + dh)
    for h in (adj.fwd, adj.bwd):
        ve, vo = _head_values(h, heads, rng)
        hd = h.to(cuda)
        ve, vo = ve.to(cuda), vo.to(cuda)
        n_x, d = int(hd.ell_cols.shape[0]), heads * dh
        x = torch.randn(n_x * d + offset, device=cuda)[offset:].reshape(n_x, d)
        before = K.ell_spmm.launches, K.hybrid_spmm.launches
        got = K.hybrid_spmm_heads(hd.ell_cols, ve, hd.ovf_ptr, hd.ovf_cols, vo, x)
        assert (K.ell_spmm.launches, K.hybrid_spmm.launches) == (before[0] + 1,
                                                                  before[1] + 1)
        _close(got, K.hybrid_spmm_heads_reference(hd.ell_cols, ve, hd.ovf_ptr,
                                                  hd.ovf_cols, vo, x))


def _heads_per_slot(h, ve, vo, x):
    """The heads form's kernel with its values read per slot, whatever H."""
    heads = int(ve.shape[-1])
    out = torch.empty((h.ell_cols.shape[0], x.shape[1]), device=x.device)
    rc = K._lib().ell_spmm_heads_f32_per_slot(
        h.ell_cols.data_ptr(), ve.data_ptr(), h.ovf_ptr.data_ptr(), h.ovf_cols.data_ptr(),
        vo.data_ptr(), x.data_ptr(), out.data_ptr(), h.ell_cols.shape[0],
        h.ell_cols.shape[1], heads, x.shape[1] // heads,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


@pytest.mark.parametrize("dh", [16, 64, 6])  # 6: the scalar path
@pytest.mark.parametrize("heads", [2, 4, 8])
@pytest.mark.parametrize("k", [0, 8, 80], ids=["all-tail", "k8", "no-tail"])
def test_hybrid_spmm_heads_values_once_a_chunk(cuda, k, heads, dh):
    """The heads form (a chunk's values read once wherever the vector path
    takes the heads) against its plain version, and bit for bit against
    the values read per slot, on both tables of a pair: zeros in single
    heads, slots zero in every head, padding; 2, 4 and 8 heads (D32: four
    rows a warp, each group picking its own register; D64 to D512: one
    warp a row)."""
    adj = _hybrid_pair(k)
    rng = np.random.default_rng(heads * 10 + dh)
    for h in (adj.fwd, adj.bwd):
        ve, vo = (t.to(cuda) for t in _head_values(h, heads, rng))
        hd = h.to(cuda)
        x = torch.randn(int(hd.ell_cols.shape[0]), heads * dh, device=cuda)
        got = K.hybrid_spmm_heads(hd.ell_cols, ve, hd.ovf_ptr, hd.ovf_cols, vo, x)
        _close(got, K.hybrid_spmm_heads_reference(hd.ell_cols, ve, hd.ovf_ptr,
                                                  hd.ovf_cols, vo, x))
        assert torch.equal(got, _heads_per_slot(hd, ve, vo, x))


@pytest.mark.parametrize("d", [64, 128, 256, 520])
@pytest.mark.parametrize("dtype", TABLE_DTYPES, ids=lambda t: str(t).split(".")[-1])
@pytest.mark.parametrize("n,k", [(1001, 8), (1001, 0), (300, 80)],
                         ids=["k8", "all-tail", "short-R-no-tail"])
def test_hybrid_spmm_table_narrow_rows(cuda, n, k, dtype, d):
    """Kernel B's storage-dtype form against its plain version on rows
    that share a warp (one 16-byte piece a lane: fp8 D64 and D128 four
    and two rows a warp, bf16 D64 four): rows of degree 0 to 5 beside
    rows of 70 in one warp's reach, tails of over 32 entries, empty rows,
    and R below one wave of the card."""
    h = _hybrid_pair(k, n=n).fwd.to(cuda)
    x = (torch.randn(n, d, device=cuda) * 4).to(dtype)
    tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
    assert int((h.ell_vals != 0).sum(1).eq(0).sum()) > 0  # empty rows
    _close(K.hybrid_spmm_table(h.ell_cols, h.ell_vals, *tail, x),
           K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x))


def test_hybrid_spmm_heads_rejects_what_the_kernel_does_not_take(cuda):
    adj = _hybrid_pair(8).fwd.to(cuda)
    ve = torch.rand(*adj.ell_cols.shape, 4, device=cuda)
    vo = torch.rand(adj.ovf_cols.shape[0], 4, device=cuda)
    x = torch.randn(adj.ell_cols.shape[0], 256, device=cuda)
    with pytest.raises(ValueError):  # 256 columns are not 3 heads
        K.hybrid_spmm_heads(adj.ell_cols, ve[..., :3].contiguous(), adj.ovf_ptr,
                            adj.ovf_cols, vo[:, :3].contiguous(), x[:, :255])
    with pytest.raises(ValueError):  # tail values of another head count
        K.hybrid_spmm_heads(adj.ell_cols, ve, adj.ovf_ptr, adj.ovf_cols, vo[:, :2], x)
    with pytest.raises(TypeError):
        K.hybrid_spmm_heads(adj.ell_cols, ve.double(), adj.ovf_ptr, adj.ovf_cols,
                            vo.double(), x)


def test_gat_conv_gradient_matches_cpu(cuda):
    """GAT's attention over a hybrid pair with its permutation on the card
    (four heads of 64; the forward and ``d_wx`` through kernel B's heads
    form, two fused launches) against the CPU plain versions: the output
    and the gradients of every parameter and of x."""
    from incagg_gnn_tpu_torch.models.gat import GATConv, gat_conv_bi

    n = 1001
    rng = np.random.default_rng(9)
    deg = rng.integers(0, 6, n)
    deg[::50] = 70
    row = np.repeat(np.arange(n), deg)
    g = CSRGraph.from_coo(row, rng.integers(0, n, row.size), n)
    adj = build_bi_hybrid_adj(g.rowptr, g.col, g.value, n, n, k=8, k_t=8,
                              ovf_pad=8192, ovf_pad_t=8192, with_perm=True)
    conv = GATConv(48, 64, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(n, 48)
    cot = torch.randn(n, 256)
    res = []
    before = K.hybrid_spmm.launches
    for dev in ("cpu", cuda):
        c = GATConv(48, 64, 4)
        c.load_state_dict(conv.state_dict())
        c = c.to(dev)
        xd = x.detach().to(dev).requires_grad_()
        out = gat_conv_bi(c, xd, adj.to(dev), True, None, 0.0, True)
        (out * cot.to(dev)).sum().backward()
        res.append([out.detach().cpu(), xd.grad.cpu(),
                    *(p.grad.cpu() for p in c.parameters())])
    assert K.hybrid_spmm.launches == before + 2
    for got, want in zip(res[1], res[0]):
        _close(got, want)


def _tied(n, d, offset, cuda, seed=0):
    """relu of normals (about half the entries exactly 0) with every 7th
    row a copy of row 0, so that a row's max is often reached by several
    slots; ``offset`` starts it off a 16-byte boundary."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n * d + offset, generator=gen, device=cuda)[offset:].reshape(n, d)
    x = x.relu_()
    x[1::7] = x[0]
    return x


@pytest.mark.parametrize("d,offset", [
    (36, 0),  # 9 lanes a row, 3 rows a warp
    (40, 0),  # PNA's last layer, one branch: 10 lanes a row, 3 rows a warp
    (128, 0),  # PNA's hidden width: 32 lanes a row; the backward in one chunk
    (132, 0),  # forward: one warp a row; backward: two chunks, the second 4 wide
    (240, 0),  # the last layer's six max/min branches stacked: backward 128 + 112
    (260, 0),  # forward: two 256-column chunks, the second 4 wide
    (768, 0),  # the hidden layers' stacked width: 3 forward, 6 backward chunks
    (772, 0),  # both with a last chunk 4 columns wide
    (6, 0), (64, 1),  # scalar path: D not a multiple of 4; x off 16 bytes
])
@pytest.mark.parametrize("k", [0, 8, 80], ids=["all-tail", "k8", "no-tail"])
def test_hybrid_max_matches_plain(cuda, k, d, offset):
    """Kernel B's max form on a pair with rows of degree 0 and forced ties:
    the forward's ``out`` and ``ties`` equal the plain version's exactly,
    with and without ties; the backward over the transpose within 1e-5 of
    the largest, and equal bit for bit when it is called again (no
    atomics, no split sums).  Each wrapper call is one counted launch."""
    adj = _hybrid_pair(k).to(cuda)
    f, b = adj.fwd, adj.bwd
    assert bool((f.deg == 0).any())
    x = _tied(int(b.ell_cols.shape[0]), d, offset, cuda)
    fwd = (f.ell_cols, f.ell_vals, f.ovf_ptr, f.ovf_cols, f.ovf_vals, f.deg, x)
    before = K.hybrid_max.launches, K.hybrid_max_bwd.launches
    out, ties = K.hybrid_max(*fwd, want_ties=True)
    out_only, none = K.hybrid_max(*fwd)
    want, want_ties = K.hybrid_max_reference(*fwd, want_ties=True)
    assert none is None
    assert torch.equal(out, want) and torch.equal(out_only, want)
    assert torch.equal(ties, want_ties) and bool((ties > 1).any())
    g = torch.randn(out.shape, device=cuda)
    bwd = (b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals, g, ties, out, x, f.deg)
    dx = K.hybrid_max_bwd(*bwd)
    _close(dx, K.hybrid_max_bwd_reference(*bwd))
    assert torch.equal(K.hybrid_max_bwd(*bwd), dx)
    assert (K.hybrid_max.launches, K.hybrid_max_bwd.launches) == (before[0] + 2,
                                                                  before[1] + 2)


def test_hybrid_max_many_waves_a_chunk(cuda):
    """A table of 103,401 rows (with every 997th row's tail past 32
    entries), at 264 columns: every column chunk (forward 256 + 8, backward
    128 + 128 + 8, each chunk's h pass in the launch of the chunk before's
    gather) spans many waves of blocks; the forward equals the plain
    version, the backward is within 1e-5 and the same bit for bit when
    called again."""
    n = 103_401
    rng = np.random.default_rng(7)
    deg = rng.integers(0, 12, n)
    deg[::997] = 60
    row = np.repeat(np.arange(n), deg)
    g = CSRGraph.from_coo(row, rng.integers(0, n, row.size), n,
                          np.ones(row.size, np.float32))
    adj = build_bi_hybrid_adj(g.rowptr, g.col, g.value, n, n, k=8, k_t=8).to(cuda)
    f, b = adj.fwd, adj.bwd
    x = _tied(n, 264, 0, cuda, seed=1)
    fwd = (f.ell_cols, f.ell_vals, f.ovf_ptr, f.ovf_cols, f.ovf_vals, f.deg, x)
    out, ties = K.hybrid_max(*fwd, want_ties=True)
    want, want_ties = K.hybrid_max_reference(*fwd, want_ties=True)
    assert torch.equal(out, want) and torch.equal(ties, want_ties)
    gr = torch.randn(out.shape, device=cuda)
    bwd = (b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals, gr, ties, out, x, f.deg)
    dx = K.hybrid_max_bwd(*bwd)
    _close(dx, K.hybrid_max_bwd_reference(*bwd))
    assert torch.equal(K.hybrid_max_bwd(*bwd), dx)


def test_hybrid_max_rejects_what_the_kernel_does_not_take(cuda):
    adj = _hybrid_pair(8).to(cuda)
    f, b = adj.fwd, adj.bwd
    x = torch.rand(1001, 40, device=cuda)
    tables = (f.ell_cols, f.ell_vals, f.ovf_ptr, f.ovf_cols, f.ovf_vals)
    with pytest.raises(TypeError):
        K.hybrid_max(*tables, f.deg, x.double())
    with pytest.raises(ValueError):  # a degree per row
        K.hybrid_max(*tables, f.deg[:-1], x)
    with pytest.raises(TypeError):
        K.hybrid_max(*tables, f.deg.double(), x)
    out, ties = K.hybrid_max(*tables, f.deg, x, want_ties=True)
    bt = (b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals)
    with pytest.raises(ValueError):  # g of another width
        K.hybrid_max_bwd(*bt, out[:, :8].contiguous(), ties, out, x, f.deg)
    with pytest.raises(ValueError):  # x rows must be the transpose's rows
        K.hybrid_max_bwd(*bt, out, ties, out, x[:-1], f.deg)
    with pytest.raises(ValueError):  # non-contiguous
        K.hybrid_max_bwd(*bt, out, ties.t().contiguous().t(), out, x, f.deg)


def test_pna_conv_gradient_matches_cpu(cuda):
    """A full PNA conv (four aggregators, three scalers, 16 -> 128) over a
    hybrid pair on the card (one kernel B launch and one max-form launch
    forward, and the same backward) against the CPU plain versions: the
    output and the gradients of every parameter and of x."""
    from incagg_gnn_tpu_torch.models.pna import PNAConfig, PNAConv, pna_conv

    adj = _hybrid_pair(8).to("cpu").binarized()
    cfg = PNAConfig(num_nodes=1001, in_channels=16, hidden_channels=128, out_channels=128,
                    num_layers=1, avg_deg_lin=2.5, avg_deg_log=1.1)
    conv = PNAConv(cfg, 16, 128, generator=torch.Generator().manual_seed(0))
    x = torch.randn(1001, 16)
    cot = torch.randn(1001, 128)
    res = []
    before = (K.hybrid_spmm.launches, K.hybrid_max.launches, K.hybrid_max_bwd.launches)
    for dev in ("cpu", cuda):
        c = PNAConv(cfg, 16, 128)
        c.load_state_dict(conv.state_dict())
        c = c.to(dev)
        xd = x.detach().to(dev).requires_grad_()
        out = pna_conv(c, xd, adj.to(dev))
        (out * cot.to(dev)).sum().backward()
        res.append([out.detach().cpu(), xd.grad.cpu(), *(p.grad.cpu() for p in c.parameters())])
    assert (K.hybrid_spmm.launches, K.hybrid_max.launches,
            K.hybrid_max_bwd.launches) == (before[0] + 2, before[1] + 1, before[2] + 1)
    for got, want in zip(res[1], res[0]):
        _close(got, want)
