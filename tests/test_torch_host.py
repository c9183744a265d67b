"""The PyTorch port's numpy host layer and builders are bit-identical to the
JAX package's: datasets, partition, permute, gcn_norm, relabel, the hybrid
and block-tier builders, and the config reader."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import datasets as J_data
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.graph import relabel as J_rel
from incagg_gnn_tpu.ops import block as J_block
from incagg_gnn_tpu.ops import ell as J_ell
from incagg_gnn_tpu.train.config import parse_overrides as j_parse_overrides
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.graph import datasets as T_data
from incagg_gnn_tpu_torch.graph import partition as T_part
from incagg_gnn_tpu_torch.graph import relabel as T_rel
from incagg_gnn_tpu_torch.ops import block as T_block
from incagg_gnn_tpu_torch.ops import ell as T_ell
from incagg_gnn_tpu_torch.train import config as T_config
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "conf", "model")


def assert_same_tree(j, t, path="adj"):
    """Field-by-field bit equality of a JAX container and the port's numpy
    container (bfloat16 compared by bit pattern).  The port holds tiles as
    their nonzeros: its ``densify()`` stands for the JAX ``a`` field.  Its
    own fields (``PORT_FIELDS``, e.g. the overflow row pointer) are not
    compared here."""
    if j is None or t is None:
        assert j is None and t is None, path
        return
    if hasattr(t, "densify"):
        assert "a" in j._fields and "a" not in t._fields, path
        assert_same_tree(j.a, t.densify(), f"{path}.a")
        for name in j._fields[1:]:
            assert_same_tree(getattr(j, name), getattr(t, name), f"{path}.{name}")
        return
    if isinstance(j, tuple):
        assert isinstance(t, tuple), path
        names = tuple(getattr(j, "_fields", range(len(j))))
        port_only = getattr(t, "PORT_FIELDS", ())
        t_names = tuple(n for n in getattr(t, "_fields", range(len(t)))
                        if n not in port_only)
        assert names == t_names, path
        t_vals = [getattr(t, n) for n in t_names] if port_only else list(t)
        assert len(j) == len(t_vals), path
        for name, a, b in zip(names, j, t_vals):
            assert_same_tree(a, b, f"{path}.{name}")
        return
    a = np.asarray(j)
    if t.dtype == np.uint16:  # the port's bfloat16 bits
        assert a.dtype.name == "bfloat16", path
        a = a.view(np.uint16)
    assert a.dtype == t.dtype, (path, a.dtype, t.dtype)
    assert a.shape == t.shape, (path, a.shape, t.shape)
    assert np.array_equal(a, t), path


def assert_ovf_ptr(adj, n_real=None):
    """The port's overflow row pointer: ascending, its rows are the first
    ``ovf_ptr[-1]`` overflow entries' rows, and every entry past them is
    padding (row ``R_pad-1``, weight 0); ``n_real`` pins the real count."""
    ptr = adj.ovf_ptr
    n = int(ptr[-1])
    assert ptr.dtype == np.int32 and ptr.shape == (adj.num_rows + 1,)
    assert ptr[0] == 0 and (np.diff(ptr) >= 0).all()
    rows = np.repeat(np.arange(adj.num_rows), np.diff(ptr))
    assert np.array_equal(rows, adj.ovf_rows[:n])
    assert (adj.ovf_rows[n:] == adj.num_rows - 1).all() and (adj.ovf_vals[n:] == 0).all()
    if n_real is not None:
        assert n == n_real


def assert_same_data(j, t):
    for f in ("x", "y", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(j.adj_t.rowptr, t.adj_t.rowptr)
    assert np.array_equal(j.adj_t.col, t.adj_t.col)
    assert (j.adj_t.value is None) == (t.adj_t.value is None)
    if j.adj_t.value is not None:
        assert np.array_equal(j.adj_t.value, t.adj_t.value)


@pytest.mark.parametrize("kwargs", [
    dict(num_nodes=400, num_classes=4, num_features=16, avg_degree=8.0, seed=1),
    dict(num_nodes=600, num_classes=5, num_features=8, avg_degree=12.0, seed=3,
         degree_skew=0.8, label_noise=0.1, multilabel=True),
])
def test_make_sbm_identical(kwargs):
    (jd, ji, jo), (td, ti, to) = J_data.make_sbm(**kwargs), T_data.make_sbm(**kwargs)
    assert (ji, jo) == (ti, to)
    assert_same_data(jd, td)


def test_get_data_presets_identical():
    for name in ("sbm-tiny", "sbm-small"):
        (jd, *jr), (td, *tr) = J_data.get_data("", name), T_data.get_data("", name)
        assert jr == tr
        assert_same_data(jd, td)
    # a real dataset's name loads its archive; a missing one raises as in JAX
    msgs = []
    for pkg in (J_data, T_data):
        with pytest.raises(FileNotFoundError, match="preprocessed to npz") as e:
            pkg.get_data("", "arxiv")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _pipeline(pkg_csr, pkg_part, data, num_parts):
    perm, ptr = pkg_part.partition_graph(data.adj_t, num_parts, seed=0)
    out = pkg_csr.permute(data, perm)
    out.adj_t = pkg_csr.gcn_norm(out.adj_t.set_diag())
    return perm, ptr, out


def test_partition_permute_norm_identical(sbm_small):
    data = sbm_small[0]
    tdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col),
        x=data.x, y=data.y, train_mask=data.train_mask,
        val_mask=data.val_mask, test_mask=data.test_mask)
    jp, jptr, jd = _pipeline(J_csr, J_part, data, 8)
    tp, tptr, td = _pipeline(T_csr, T_part, tdata, 8)
    assert np.array_equal(jp, tp) and np.array_equal(jptr, tptr)
    assert_same_data(jd, td)
    # the multilevel partitioner too
    a = J_part.partition_graph(data.adj_t, 5, seed=3, method="multilevel")
    b = T_part.partition_graph(tdata.adj_t, 5, seed=3, method="multilevel")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _normed_graph(sbm):
    data = sbm[0]
    perm, ptr = J_part.partition_graph(data.adj_t, 8, seed=0)
    data = J_csr.permute(data, perm)
    adj = J_csr.gcn_norm(data.adj_t.set_diag())
    return T_csr.CSRGraph(adj.rowptr, adj.col, adj.value), ptr


@pytest.mark.parametrize("within", [False, True])
def test_relabel_identical(sbm_small, within):
    adj, ptr = _normed_graph(sbm_small)
    idx = np.concatenate([np.arange(ptr[1], ptr[2]), np.arange(ptr[5], ptr[7])])
    jf = J_rel.relabel_one_hop_within_batch if within else J_rel.relabel_one_hop
    tf = T_rel.relabel_one_hop_within_batch if within else T_rel.relabel_one_hop
    for bipartite in (True, False):
        for a, b in zip(jf(adj, idx, bipartite), tf(adj, idx, bipartite)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _skewed_csr(rng, n=20000, heavy=2000):
    """Degree 4 rows plus ``heavy`` degree-60 rows, so that the level
    optimizer adds ELL extension levels and the overflow is large."""
    deg = np.full(n, 4)
    deg[rng.choice(n, heavy, replace=False)] = 60
    row = np.repeat(np.arange(n), deg)
    col = rng.integers(0, n, row.size)
    val = rng.random(row.size).astype(np.float32)
    return J_csr.CSRGraph.from_coo(row, col, n, val, coalesce=False)


def _batch_csr(sbm):
    adj, ptr = _normed_graph(sbm)
    idx = np.arange(ptr[0], ptr[2])
    rowptr, col, val, n_id = J_rel.relabel_one_hop(adj, idx)
    r_pad = -(-len(idx) // 128) * 128
    c_pad = -(-len(n_id) // 128) * 128
    return rowptr, col, val, r_pad, c_pad


@pytest.mark.parametrize("case", ["ext_inc", "static", "auto", "empty"])
def test_build_hybrid_identical(rng, case):
    g = _skewed_csr(rng)
    n = g.num_nodes
    n_pad = -(-n // 128) * 128
    rowptr, col, val = g.rowptr, g.col, g.value
    kw = {}
    if case == "ext_inc":
        kw = dict(bucket_ext=True, ovf_inc=True)
    elif case == "static":
        kw = dict(k=16, ovf_pad=98304, ovf_inc=True)
    elif case == "empty":
        rowptr, col, val = np.zeros(n + 1, np.int64), col[:0], val[:0]
    j = J_ell.build_hybrid_adj(rowptr, col, val, n_pad, n_pad, **kw)
    t = T_ell.build_hybrid_adj(rowptr, col, val, n_pad, n_pad, **kw)
    if case == "ext_inc":
        assert t.ext and t.ovf_inc is not None
    assert_same_tree(j, t)
    assert_ovf_ptr(t, 0 if case == "empty" else None)


@pytest.mark.parametrize("static", [False, True])
def test_build_bi_hybrid_identical(rng, static):
    g = _skewed_csr(rng, n=1000, heavy=100)
    n_pad = 1024
    kw = dict(k=16, k_t=16, ovf_pad=8192, ovf_pad_t=8192) if static else {}
    j = J_ell.build_bi_hybrid_adj(g.rowptr, g.col, g.value, n_pad, n_pad, **kw)
    t = T_ell.build_bi_hybrid_adj(g.rowptr, g.col, g.value, n_pad, n_pad, **kw)
    assert j.t2f is None and t.t2f is None
    assert_same_tree(j, t)
    assert_ovf_ptr(t.fwd)
    assert_ovf_ptr(t.bwd)


def test_overflow_ptr_leaves_padding_out():
    """The tail pointer on a static build whose overflow is padded: the
    padding entries (all in the last row) belong to no row, though the
    last row has real overflow of its own; a row whose ELL slots hold only
    zero weights still owns its tail; the transpose gets its own pointer;
    an empty overflow gives an all-zero pointer.  The JAX package's fields
    stay bit-identical."""
    n, k = 256, 8
    deg = np.full(n, 3)
    deg[[3, n - 1]] = (k + 5, k + 40)  # row 3: tail of 5; last row: 40
    row = np.repeat(np.arange(n), deg)
    col = (row * 7 + np.arange(row.size)) % n
    val = np.linspace(0.5, 1.5, row.size).astype(np.float32)
    val[np.flatnonzero(row == 3)[:k]] = 0.0  # row 3: no real ELL slot
    g = J_csr.CSRGraph.from_coo(row, col, n, val, coalesce=False)
    args = (g.rowptr, g.col, g.value, n, n)
    kw = dict(k=k, k_t=k, ovf_pad=1024, ovf_pad_t=1024)
    t = T_ell.build_bi_hybrid_adj(*args, **kw)
    assert_same_tree(J_ell.build_bi_hybrid_adj(*args, **kw), t)
    f = t.fwd
    assert_ovf_ptr(f, 45)
    assert f.ovf_rows.size == 1024 and (f.ovf_rows[45:] == n - 1).all()
    assert f.ovf_ptr[n] - f.ovf_ptr[n - 1] == 40
    assert (f.ell_vals[3] == 0).all() and f.ovf_ptr[4] - f.ovf_ptr[3] == 5
    t_deg = np.bincount(col, minlength=n)
    assert_ovf_ptr(t.bwd, int(np.maximum(t_deg - k, 0).sum()))
    empty = T_ell.build_hybrid_adj(np.zeros(n + 1, np.int64), col[:0], val[:0], n, n,
                                   k=k, ovf_pad=128)
    assert_ovf_ptr(empty, 0)
    assert not empty.ovf_ptr.any()


@pytest.mark.parametrize("rb,bf16", [(128, False), (256, False), (128, True),
                                     (512, False), (256, True), (512, True)])
def test_build_block_hybrid_identical(sbm_small, rb, bf16):
    import ml_dtypes

    rowptr, col, val, r_pad, c_pad = _batch_csr(sbm_small)
    thresh = J_block.marginal_thresh(4, 4, 32, rb)
    ja = ml_dtypes.bfloat16 if bf16 else np.float32
    ta = T_block.BF16 if bf16 else np.float32
    j = J_block.build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh,
                                   a_dtype=ja, rb_rows=rb)
    t = T_block.build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh,
                                   a_dtype=ta, rb_rows=rb)
    assert (t.dense.vals != 0).any() and t.dense.rb == rb
    assert_same_tree(j, t)
    assert_ovf_ptr(t.rem)
    # the planners agree too
    assert (J_block.plan_block_tier_rb(rowptr, col, c_pad, d_hint=32)
            == T_block.plan_block_tier_rb(rowptr, col, c_pad, d_hint=32))
    jm = J_block.measure_block_tier(rowptr, col, r_pad, c_pad, thresh, rb)
    tm = T_block.measure_block_tier(rowptr, col, r_pad, c_pad, thresh, rb)
    assert jm[0] == tm[0] and np.array_equal(jm[1], tm[1])


def _duplicate_csr(rng, n=1024, m=30000):
    """Clustered edges (dense tiles appear) plus repeated and cancelling
    ``(row, col)`` entries, uncoalesced: cells summing two or three edges,
    cells summing to exactly zero in f32 and bf16 (bf16-exact values), and
    one cell whose bf16 sum rounds to -0.0."""
    row = rng.integers(0, n, m)
    col = (row // 256) * 256 + rng.integers(0, 256, m)
    val = rng.integers(1, 64, m).astype(np.float32) / 64
    d = rng.choice(m, 3000, replace=False)
    row = np.concatenate([row, row[d], row[d[:1000]], [9]])
    col = np.concatenate([col, col[d], col[d[:1000]], [11]])
    tiny = np.array([0x80000001], np.uint32).view(np.float32)  # -1.4e-45
    val = np.concatenate([val, val[d], -2 * val[d[:1000]], tiny])
    return J_csr.CSRGraph.from_coo(row, col, n, val.astype(np.float32),
                                   coalesce=False)


@pytest.mark.parametrize("bf16", [False, True])
def test_build_block_hybrid_sums_duplicate_edges(rng, bf16):
    """Duplicate edges are summed into one entry as the native builder sums
    them into the tile (f32 ``+=``, bf16 rounded after each add); cells that
    cancel are dropped; ``densify()`` is the JAX tile list bit for bit."""
    import ml_dtypes

    g = _duplicate_csr(rng)
    j = J_block.build_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, 20,
                                   a_dtype=ml_dtypes.bfloat16 if bf16 else np.float32)
    t = T_block.build_block_hybrid(g.rowptr, g.col, g.value, 1024, 1024, 20,
                                   a_dtype=T_block.BF16 if bf16 else np.float32)
    assert_same_tree(j, t)
    rows = np.repeat(np.arange(1024), np.diff(t.dense.rowptr))
    key = rows.astype(np.int64) * 1024 + t.dense.cols
    assert (np.diff(key) > 0).all()  # one entry per cell, ascending per row
    bits = t.dense.vals.view(np.uint16 if bf16 else np.uint32)
    assert (bits != 0).all() and t.dense.vals.size < g.col.size - t.rem.deg.sum()


@pytest.mark.parametrize("static", [False, True])
def test_build_bi_block_hybrid_identical(sbm_small, static):
    rowptr, col, val, r_pad, c_pad = _batch_csr(sbm_small)
    thresh = J_block.marginal_thresh(4, 4, 32)
    kw = {}
    if static:
        nb = J_block.measure_block_tier(rowptr, col, r_pad, c_pad, thresh)[0]
        kw = dict(ovf_pad=4096, ovf_pad_t=4096, nb_pad=nb + 8, nb_pad_t=2 * nb)
    j = J_block.build_bi_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh, **kw)
    t = T_block.build_bi_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh, **kw)
    assert_same_tree(j, t)


@pytest.mark.parametrize("name", ["appnp", "gat", "gcn", "gcn2", "graphsage", "pna"])
def test_config_reader_matches_pyyaml(name):
    text = open(os.path.join(CONF, f"{name}.yaml")).read()
    assert T_config.load_yaml(text) == yaml.safe_load(text)


def test_override_values_match_pyyaml(monkeypatch):
    argv = ["vr_update=true", "lr=5.0e-05", "epochs=3", "grad_norm=null",
            "adj_format=block", "dropout=0.0", "aggregators=[mean, max]",
            "x={a: 1, b: [2, off]}", "name=1e-5", "+seed=7"]
    want = j_parse_overrides(argv)
    monkeypatch.setattr(T_config, "yaml", None)
    assert T_config.parse_overrides(argv) == want
    assert sorted(glob.glob(os.path.join(CONF, "*.yaml"))) == [
        os.path.join(CONF, f"{n}.yaml")
        for n in ("appnp", "gat", "gcn", "gcn2", "graphsage", "pna")]
    cfg = T_config.load_config(os.path.join(CONF, "gcn.yaml"), "sbm-arxiv",
                               T_config.parse_overrides(["epochs=1"]))
    assert cfg.trainer.num_parts == 80 and cfg.trainer.batch_size == 40
    assert cfg.architecture["hidden_channels"] == 256 and cfg.trainer.epochs == 1


def test_train_loader_streams_a_set_the_device_cannot_hold(sbm_small):
    """A shuffled single-cluster training set over the device budget is
    collated anew each epoch, not held on the host; it yields the same
    batches, in the same order, as the cached one."""
    from incagg_gnn_tpu_torch.loader import SubgraphLoader

    data = sbm_small[0]
    adj = T_csr.gcn_norm(T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col,
                                        data.adj_t.value).set_diag())
    tdata = T_csr.GraphData(adj_t=adj, x=data.x, y=data.y, train_mask=data.train_mask,
                            val_mask=data.val_mask, test_mask=data.test_mask)
    ptr = np.linspace(0, data.num_nodes, 9).astype(np.int64)
    kw = dict(batch_size=1, mode="gas", shuffle=True, seed=3, adj_format="block",
              block_d_hint=32, block_force=True)
    cached = SubgraphLoader(tdata, ptr, "cpu", **kw)
    streamed = SubgraphLoader(tdata, ptr, "cpu", **kw)
    streamed.hbm_budget = 1
    for _ in range(2):  # two epochs, two orders
        pairs = list(zip(cached, streamed))
        assert len(pairs) == 8
        for a, b in pairs:
            assert np.array_equal(a.n_id, b.n_id)
            # the same tile entries; a streamed pass pads them to the entry
            # count seen so far, the cached set to the whole set's
            da, db = a.device.adj.fwd.dense, b.device.adj.fwd.dense
            n = int(da.rowptr[-1])
            for x, y in zip(da._replace(cols=da.cols[:n], vals=da.vals[:n]),
                            db._replace(cols=db.cols[:n], vals=db.vals[:n])):
                assert torch.equal(x, y)
            assert not db.vals[n:].any()
    assert streamed._stream and streamed._cache is None
    assert not cached._stream and len(cached._cache) == 8
