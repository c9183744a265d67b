"""The port's dataset layer against the JAX package's: the three ``sbm-ppi``
graphs, ``gen_masks`` and an archive with edge values and a multilabel ``y``
bit for bit, the errors of a bad split and a missing archive, and
``incagg_gnn_tpu_torch.convert_dataset`` against ``scripts/convert_dataset.py``
on raw files of each of the six formats, flags included: the same archives,
array for array."""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from incagg_gnn_tpu.graph import datasets as J_ds
from incagg_gnn_tpu.utils.metrics import gen_masks as j_gen_masks
from incagg_gnn_tpu_torch import convert_dataset as T_conv
from incagg_gnn_tpu_torch.graph import datasets as T_ds
from incagg_gnn_tpu_torch.utils.metrics import gen_masks as t_gen_masks
from test_convert_roundtrip import _write_ogb_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("x", "y", "train_mask", "val_mask", "test_mask")


def _jax_script():
    """``scripts/convert_dataset.py``, loaded by path."""
    path = os.path.join(REPO, "scripts", "convert_dataset.py")
    spec = importlib.util.spec_from_file_location("jax_convert_dataset", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _same_data(j, t):
    _same(j.adj_t.rowptr, t.adj_t.rowptr, "rowptr")
    _same(j.adj_t.col, t.adj_t.col, "col")
    assert (j.adj_t.value is None) == (t.adj_t.value is None)
    if j.adj_t.value is not None:
        _same(j.adj_t.value, t.adj_t.value, "value")
    for f in FIELDS:
        _same(getattr(j, f), getattr(t, f), f)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_sbm_ppi_splits_bit_for_bit(split):
    kw = dict(num_nodes=400, num_classes=6, num_features=12, seed=3)
    j, j_in, j_out = J_ds.get_data("", "sbm-ppi", split=split, **kw)
    t, t_in, t_out = T_ds.get_data("", "sbm-ppi", split=split, **kw)
    assert (j_in, j_out) == (t_in, t_out) == (12, 6)
    _same_data(j, t)
    assert t.multilabel and getattr(t, f"{split}_mask").all()
    assert T_ds.INDUCTIVE_DATASETS == J_ds.INDUCTIVE_DATASETS


def test_gen_masks_bit_for_bit():
    y = np.random.default_rng(0).integers(0, 5, size=300).astype(np.int32)
    for seed in (0, 12345):
        for j, t in zip(j_gen_masks(y, 7, 9, num_splits=4, seed=seed),
                        t_gen_masks(y, 7, 9, num_splits=4, seed=seed)):
            _same(j, t, "mask")


def test_archive_with_values_and_multilabel_y(tmp_path):
    d, _, _ = T_ds.make_sbm_inductive(split="val", num_nodes=400, seed=1)
    value = np.random.default_rng(2).random(d.adj_t.nnz).astype(np.float32)
    os.makedirs(tmp_path / "ppi")
    np.savez(tmp_path / "ppi" / "data_val.npz", rowptr=d.adj_t.rowptr, col=d.adj_t.col,
             value=value, x=d.x.astype(np.float64), y=d.y, train_mask=d.train_mask,
             val_mask=d.val_mask, test_mask=d.test_mask)
    j, j_in, j_out = J_ds.get_data(str(tmp_path), "ppi", split="val")
    t, t_in, t_out = T_ds.get_data(str(tmp_path), "ppi", split="val")
    assert (j_in, j_out) == (t_in, t_out) == (d.num_features, d.num_classes)
    _same_data(j, t)
    _same(t.adj_t.value, value, "value")
    assert t.y.dtype == np.float32 and t.y.ndim == 2 and t.x.dtype == np.float32


def test_bad_split_and_missing_archive_raise_as_in_jax(tmp_path):
    for mod in (J_ds, T_ds):
        with pytest.raises(ValueError, match="split must be train/val/test"):
            mod.make_sbm_inductive(split="validation")
    msgs = []
    for mod, name in ((J_ds, "arxiv"), (T_ds, "arxiv"), (J_ds, "ppi"), (T_ds, "ppi")):
        with pytest.raises(FileNotFoundError, match="preprocessed to npz") as e:
            mod.get_data(str(tmp_path), name, split="test")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]
    assert msgs[2].endswith("no network egress is available to download them.")
    assert "data_test.npz" in msgs[2] and "data.npz" in msgs[0]


# ---------------------------------------------------------------------------
# raw files of each format (the layouts the converters document)
# ---------------------------------------------------------------------------

def _edges(rng, n, m):
    e = rng.integers(0, n, size=(m, 2))
    return e[e[:, 0] != e[:, 1]]


def _saint(src, rng, n=50, f=4, c=3, multilabel=False):
    e = _edges(rng, n, 3 * n)
    adj = sp.csr_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    sp.save_npz(os.path.join(src, "adj_full.npz"), adj)
    np.save(os.path.join(src, "feats.npy"), rng.normal(size=(n, f)))
    if multilabel:
        cmap = {str(i): rng.integers(0, 2, size=c).tolist() for i in range(n)}
    else:
        cmap = {str(i): int(rng.integers(0, c)) for i in range(n)}
    perm = rng.permutation(n).tolist()
    with open(os.path.join(src, "class_map.json"), "w") as fh:
        json.dump(cmap, fh)
    with open(os.path.join(src, "role.json"), "w") as fh:
        json.dump({"tr": perm[:25], "va": perm[25:35], "te": perm[35:]}, fh)
    return src


def _planetoid(src, rng, f=5, c=3):
    """ind.tiny.{x,tx,allx,y,ty,ally,graph,test.index}: 30 labelled nodes
    (the first 10 the training set), 10 test nodes in shuffled order."""
    n_all, n_test = 30, 10
    test_idx = rng.permutation(np.arange(n_all, n_all + n_test))
    allx = sp.csr_matrix(rng.normal(size=(n_all, f)))
    onehot = np.eye(c)[rng.integers(0, c, size=n_all + n_test)]
    parts = {"x": allx[:10], "tx": sp.csr_matrix(rng.normal(size=(n_test, f))),
             "allx": allx, "y": onehot[:10], "ty": onehot[n_all:],
             "ally": onehot[:n_all],
             "graph": {v: rng.integers(0, n_all + n_test, size=3).tolist()
                       for v in range(n_all + n_test)}}
    prefix = os.path.join(src, "ind.tiny")
    for ext, obj in parts.items():
        with open(f"{prefix}.{ext}", "wb") as fh:
            pickle.dump(obj, fh)
    np.savetxt(f"{prefix}.test.index", test_idx, fmt="%d")
    return prefix


def _ppi(src, rng, f=6, c=4):
    for raw, n in (("train", 60), ("valid", 20), ("test", 25)):
        e = _edges(rng, n, 3 * n)
        links = [{"source": int(a), "target": int(b)} for a, b in e]
        with open(os.path.join(src, f"{raw}_graph.json"), "w") as fh:
            json.dump({"directed": False, "nodes": [{"id": i} for i in range(n)],
                       "links": links}, fh)
        np.save(os.path.join(src, f"{raw}_feats.npy"), rng.normal(size=(n, f)))
        np.save(os.path.join(src, f"{raw}_labels.npy"),
                rng.integers(0, 2, size=(n, c)).astype(np.int64))
    return src


def _wikics(src, rng, n=40, f=5, c=3):
    d = {"features": rng.normal(size=(n, f)).tolist(),
         "labels": rng.integers(0, c, size=n).tolist(),
         "links": [rng.integers(0, n, size=int(rng.integers(0, 4))).tolist()
                   for _ in range(n)],
         "train_masks": (rng.random((20, n)) < 0.3).tolist(),
         "stopping_masks": (rng.random((20, n)) < 0.2).tolist(),
         "test_mask": (rng.random(n) < 0.5).tolist()}
    with open(os.path.join(src, "data.json"), "w") as fh:
        json.dump(d, fh)
    return src


def _gnnbench(src, rng, n=120, f=7, c=3):
    adj = sp.csr_matrix(sp.random(n, n, density=0.05, random_state=1, format="csr"))
    attr = sp.csr_matrix(sp.random(n, f, density=0.4, random_state=2, format="csr"))
    path = os.path.join(src, "tiny.npz")
    np.savez(path, adj_shape=np.array(adj.shape), adj_indptr=adj.indptr,
             adj_indices=adj.indices, adj_data=adj.data, attr_shape=np.array(attr.shape),
             attr_indptr=attr.indptr, attr_indices=attr.indices,
             attr_data=attr.data.astype(np.float32),
             labels=rng.integers(0, c, size=n),
             idx_to_node=np.array({0: "node"}, dtype=object))
    return path


def _ogb(src, rng):
    _write_ogb_fixture(src)
    return src


RAW = {"ogb": _ogb, "saint": _saint, "planetoid": _planetoid, "ppi": _ppi,
       "wikics": _wikics, "gnnbench": _gnnbench,
       "saint-multilabel": lambda src, rng: _saint(src, rng, multilabel=True)}


@pytest.mark.parametrize("fmt,flags", [
    pytest.param("ogb", [], id="ogb"),
    pytest.param("saint", [], id="saint"),
    pytest.param("saint-multilabel", ["--argmax-labels", "--standardize-features"],
                 id="saint-amazon-flags"),
    pytest.param("planetoid", [], id="planetoid"),
    pytest.param("ppi", [], id="ppi"),
    pytest.param("wikics", ["--split-idx", "3"], id="wikics"),
    pytest.param("gnnbench", ["--mask-seed", "7", "--split-idx", "2"], id="gnnbench"),
])
def test_converter_matches_the_jax_script(tmp_path, monkeypatch, capsys, fmt, flags):
    raw = tmp_path / "raw"
    os.makedirs(raw)
    src = RAW[fmt](str(raw), np.random.default_rng(4))
    args = ["--format", fmt.split("-")[0], "--src", src, *flags]
    jax_out, port_out = tmp_path / "jax" / "data.npz", tmp_path / "port" / "data.npz"
    monkeypatch.setattr(sys, "argv", ["convert_dataset.py", *args, "--out", str(jax_out)])
    _jax_script().main()
    T_conv.main([*args, "--out", str(port_out)])
    capsys.readouterr()
    names = sorted(os.listdir(jax_out.parent))
    assert names == sorted(os.listdir(port_out.parent))
    assert names == (["data_test.npz", "data_train.npz", "data_val.npz"]
                     if fmt == "ppi" else ["data.npz"])
    for name in names:
        with np.load(jax_out.parent / name) as j, np.load(port_out.parent / name) as t:
            assert sorted(j.files) == sorted(t.files)
            for key in j.files:
                _same(j[key], t[key], f"{name}:{key}")
    # and the archive loads through the port's registry
    split = "val" if fmt == "ppi" else None
    data, _, _ = T_ds.load_npz_dataset(str(tmp_path), "port", split=split)
    assert data.num_nodes == data.x.shape[0] > 0
