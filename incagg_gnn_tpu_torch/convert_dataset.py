"""Convert raw dataset files into the ``.npz`` archives that
``graph/datasets.py::load_npz_dataset`` reads (the port's counterpart of
``scripts/convert_dataset.py``, which imports the JAX package; this module
imports numpy only, and scipy for the ``saint`` and ``planetoid`` formats).

The reference downloads datasets through PyG/OGB at runtime (data.py:118-145);
without network access, real datasets are converted once from raw files:

    python -m incagg_gnn_tpu_torch.convert_dataset --format ogb   --src path/to/ogbn_arxiv --out {root}/arxiv/data.npz
    python -m incagg_gnn_tpu_torch.convert_dataset --format saint --src path/to/reddit_raw --out {root}/reddit/data.npz
    python -m incagg_gnn_tpu_torch.convert_dataset --format ppi   --src path/to/ppi_raw    --out {root}/ppi/data.npz

Supported inputs:
- ``ogb``: an extracted OGB node-prediction directory (raw/ with
  edge.csv.gz, node-feat.csv.gz, node-label.csv.gz, split/...).
- ``saint``: GraphSAINT-style raw files (adj_full.npz [scipy CSR],
  feats.npy, class_map.json, role.json): Reddit/Flickr/Yelp/AmazonProducts
  as GraphSAINT distributes them (reference data.py:81-116; for
  AmazonProducts add --argmax-labels --standardize-features to match
  get_amazon_products, data.py:47-53).
- ``planetoid``: Planetoid pickles (Cora/Citeseer/Pubmed).
- ``ppi``: PyG PPI raw files; writes data_{train,val,test}.npz per-split
  archives beside ``--out`` for the inductive protocol (reference get_ppi,
  data.py:100-107).
- ``wikics``: WikiCS data.json (reference get_wikics, data.py:21-28).
- ``gnnbench``: gnn-benchmark npz: Coauthor CS/Physics, Amazon
  Computers/Photo (reference get_coauthor/get_amazon, data.py:30-45).

Output archive keys: rowptr, col, x, y, train_mask, val_mask, test_mask.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os

import numpy as np

from incagg_gnn_tpu_torch.utils.metrics import gen_masks


def _json(path):
    with open(path) as f:
        return json.load(f)


def _csv_gz(path, **kwargs):
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", **kwargs)


def symmetrize(row, col, n):
    r = np.concatenate([row, col])
    c = np.concatenate([col, row])
    keep = r != c
    r, c = r[keep], c[keep]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    dup = np.concatenate([[False], (r[1:] == r[:-1]) & (c[1:] == c[:-1])])
    r, c = r[~dup], c[~dup]
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rowptr, r + 1, 1)
    return np.cumsum(rowptr), c.astype(np.int32)


def convert_ogb(src: str):
    raw = os.path.join(src, "raw")
    edges = _csv_gz(os.path.join(raw, "edge.csv.gz"), dtype=np.int64)
    x = _csv_gz(os.path.join(raw, "node-feat.csv.gz"), dtype=np.float32)
    y = _csv_gz(os.path.join(raw, "node-label.csv.gz"), dtype=np.int64).reshape(-1)
    n = x.shape[0]
    rowptr, col = symmetrize(edges[:, 0], edges[:, 1], n)
    split_dir = None
    for cand in ("split/time", "split/sales_ranking", "split"):
        d = os.path.join(src, cand)
        if os.path.exists(os.path.join(d, "train.csv.gz")):
            split_dir = d
            break
    masks = {}
    for name in ("train", "valid", "test"):
        idx = _csv_gz(os.path.join(split_dir, f"{name}.csv.gz"),
                      dtype=np.int64).reshape(-1)
        m = np.zeros(n, dtype=bool)
        m[idx] = True
        masks[name] = m
    return rowptr, col, x, y.astype(np.int32), masks["train"], masks["valid"], masks["test"]


def convert_saint(src: str):
    import scipy.sparse as sp

    adj = sp.load_npz(os.path.join(src, "adj_full.npz")).tocsr()
    x = np.load(os.path.join(src, "feats.npy")).astype(np.float32)
    n = x.shape[0]
    class_map = _json(os.path.join(src, "class_map.json"))
    first = next(iter(class_map.values()))
    if isinstance(first, list):  # multi-label (yelp/amazon)
        y = np.zeros((n, len(first)), dtype=np.float32)
        for k, v in class_map.items():
            y[int(k)] = v
    else:
        y = np.zeros(n, dtype=np.int32)
        for k, v in class_map.items():
            y[int(k)] = v
    role = _json(os.path.join(src, "role.json"))
    masks = []
    for key in ("tr", "va", "te"):
        m = np.zeros(n, dtype=bool)
        m[np.asarray(role[key])] = True
        masks.append(m)
    coo = adj.tocoo()
    rowptr, col = symmetrize(coo.row.astype(np.int64), coo.col.astype(np.int64), n)
    return rowptr, col, x, y, masks[0], masks[1], masks[2]


def convert_planetoid(src: str):
    """Planetoid raw pickles (ind.{name}.{x,tx,allx,y,ty,ally,graph,test.index})
    — covers Cora/Citeseer/Pubmed (reference: get_planetoid, data.py:15-36).
    ``src`` is the directory plus dataset prefix, e.g. ``raw/ind.cora``."""
    import pickle

    def load(ext):
        with open(f"{src}.{ext}", "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = load("x"), load("tx"), load("allx")
    y, ty, ally = load("y"), load("ty"), load("ally")
    graph = load("graph")
    test_idx = np.loadtxt(f"{src}.test.index", dtype=np.int64)
    test_sorted = np.sort(test_idx)

    import scipy.sparse as sp

    def dense(m):
        return m.toarray() if sp.issparse(m) else np.asarray(m)

    allx, tx = dense(allx), dense(tx)
    n = int(max(test_idx.max() + 1, allx.shape[0] + tx.shape[0]))
    feat = np.zeros((n, allx.shape[1]), dtype=np.float32)
    feat[: allx.shape[0]] = allx
    feat[test_sorted] = tx
    labels = np.zeros((n, np.asarray(ally).shape[1]), dtype=np.float32)
    labels[: allx.shape[0]] = ally
    labels[test_sorted] = ty
    y_idx = labels.argmax(1).astype(np.int32)

    rows, cols = [], []
    for v, nbrs in graph.items():
        for u in nbrs:
            rows.append(v)
            cols.append(u)
    rowptr, col = symmetrize(np.array(rows), np.array(cols), n)

    train_mask = np.zeros(n, bool)
    train_mask[: dense(x).shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[dense(x).shape[0] : dense(x).shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_sorted] = True
    return rowptr, col, feat, y_idx, train_mask, val_mask, test_mask


def convert_ppi(src: str):
    """PyG PPI raw files ({split}_graph.json node-link JSON, {split}_feats.npy,
    {split}_labels.npy) — the inductive protocol (reference: get_ppi,
    data.py:100-107, which Batch-concatenates each split's graphs; the raw
    split graph is already that union).  Returns one archive per split with
    the split's own mask all-True (reference data.py:105)."""
    out = {}
    for split, raw in (("train", "train"), ("val", "valid"), ("test", "test")):
        g = _json(os.path.join(src, f"{raw}_graph.json"))
        x = np.load(os.path.join(src, f"{raw}_feats.npy")).astype(np.float32)
        y = np.load(os.path.join(src, f"{raw}_labels.npy")).astype(np.float32)
        n = x.shape[0]
        row = np.array([e["source"] for e in g["links"]], dtype=np.int64)
        col_ = np.array([e["target"] for e in g["links"]], dtype=np.int64)
        rowptr, col = symmetrize(row, col_, n)
        masks = {s: np.full(n, s == split, dtype=bool)
                 for s in ("train", "val", "test")}
        out[split] = (rowptr, col, x, y,
                      masks["train"], masks["val"], masks["test"])
    return out


def convert_wikics(src: str, split_idx: int = 0):
    """WikiCS ``data.json`` (features, labels, links adjacency lists, 20
    train/val/stopping splits + one test mask).  The reference uses the
    *stopping* mask as val (get_wikics, data.py:21-28); ``split_idx`` picks
    one of the 20 published splits."""
    d = _json(os.path.join(src, "data.json"))
    x = np.asarray(d["features"], dtype=np.float32)
    y = np.asarray(d["labels"], dtype=np.int32)
    n = x.shape[0]
    rows, cols = [], []
    for v, nbrs in enumerate(d["links"]):
        for u in nbrs:
            rows.append(v)
            cols.append(u)
    rowptr, col = symmetrize(np.array(rows), np.array(cols), n)
    tr = np.asarray(d["train_masks"][split_idx], dtype=bool)
    va = np.asarray(d["stopping_masks"][split_idx], dtype=bool)
    te = np.asarray(d["test_mask"], dtype=bool)
    return rowptr, col, x, y, tr, va, te


def convert_gnnbench(src: str, mask_seed: int = 12345, split_idx: int = 0):
    """gnn-benchmark ``.npz`` (adj_* CSR, attr_* CSR features, labels) —
    covers Coauthor CS/Physics and Amazon Computers/Photo.  These datasets
    ship no splits; like the reference (get_coauthor/get_amazon,
    data.py:30-45) masks come from ``gen_masks(y, 20, 30, 20)`` under a fixed
    seed, taking split ``split_idx``."""
    # numeric arrays only: the archive's pickled name lists are never read
    path = src if src.endswith(".npz") else os.path.join(src, "data.npz")
    with np.load(path) as z:
        n = int(z["adj_shape"][0])
        adj_indptr = z["adj_indptr"]
        adj_col = z["adj_indices"].astype(np.int64)
        row = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(adj_indptr).astype(np.int64))
        rowptr, col = symmetrize(row, adj_col, n)
        f = int(z["attr_shape"][1])
        x = np.zeros((n, f), dtype=np.float32)
        arow = np.repeat(np.arange(n), np.diff(z["attr_indptr"]).astype(np.int64))
        x[arow, z["attr_indices"]] = z["attr_data"]
        y = z["labels"].astype(np.int32)
    tr, va, te = gen_masks(y, 20, 30, num_splits=20, seed=mask_seed)
    return rowptr, col, x, y, tr[:, split_idx], va[:, split_idx], te[:, split_idx]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch.convert_dataset")
    ap.add_argument("--format", required=True,
                    choices=["ogb", "saint", "planetoid", "ppi", "wikics",
                             "gnnbench"])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split-idx", type=int, default=0,
                    help="wikics/gnnbench: which of the 20 splits to export")
    ap.add_argument("--mask-seed", type=int, default=12345,
                    help="gnnbench: RNG seed for the generated masks "
                         "(reference data.py:33,42 pins 12345)")
    ap.add_argument("--argmax-labels", action="store_true",
                    help="collapse multi-label y to single-label argmax "
                         "(reference amazonproducts, data.py:51)")
    ap.add_argument("--standardize-features", action="store_true",
                    help="x := (x - mean) / std per feature "
                         "(reference amazonproducts, data.py:50)")
    args = ap.parse_args(argv)
    fn = {"ogb": convert_ogb, "saint": convert_saint,
          "planetoid": convert_planetoid, "ppi": convert_ppi,
          "wikics": lambda s: convert_wikics(s, args.split_idx),
          "gnnbench": lambda s: convert_gnnbench(s, args.mask_seed,
                                                 args.split_idx)}[args.format]
    res = fn(args.src)
    splits = res if isinstance(res, dict) else {None: res}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for split, (rowptr, col, x, y, tr, va, te) in splits.items():
        if args.standardize_features:
            x = (x - x.mean(axis=0)) / np.maximum(x.std(axis=0), 1e-12)
        if args.argmax_labels and y.ndim == 2:
            y = y.argmax(axis=1).astype(np.int32)
        path = args.out
        if split is not None:  # inductive: data_{split}.npz next to --out
            path = os.path.join(os.path.dirname(args.out),
                                f"data_{split}.npz")
        np.savez_compressed(path, rowptr=rowptr, col=col, x=x, y=y,
                            train_mask=tr, val_mask=va, test_mask=te)
        print(f"wrote {path}: N={len(rowptr) - 1} E={len(col)} F={x.shape[1]}")


if __name__ == "__main__":
    main()
