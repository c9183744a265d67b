"""Dataset registry (numpy only).

Port of ``incagg_gnn_tpu/graph/datasets.py``, bit-identical to the JAX
package's arrays for the same seed or archive:

1. **On-disk archives** ``{root}/{name}/data.npz`` (``data_{split}.npz``
   for the inductive datasets) holding ``rowptr, col, [value], x, y,
   train_mask, val_mask, test_mask``, as ``python -m
   incagg_gnn_tpu_torch.convert_dataset`` writes them from raw files;
2. **Synthetic generators**: the stochastic block model ``make_sbm``, its
   named presets, and ``sbm-ppi``, three graphs drawn from one class
   geometry (:func:`make_sbm_inductive`).

Loaders return ``(GraphData, in_channels, out_channels)`` like the
reference's ``get_data``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from incagg_gnn_tpu_torch.graph.csr import CSRGraph, GraphData
from incagg_gnn_tpu_torch.utils.metrics import index2mask


def make_sbm(
    num_nodes: int = 2000,
    num_classes: int = 8,
    num_features: int = 32,
    avg_degree: float = 10.0,
    p_in: float = 0.85,
    feature_noise: float = 1.0,
    train_frac: float = 0.3,
    val_frac: float = 0.2,
    seed: int = 0,
    multilabel: bool = False,
    centers_seed: int | None = None,
    label_noise: float = 0.0,
    degree_skew: float = 0.0,
) -> Tuple[GraphData, int, int]:
    """Stochastic-block-model graph with class-correlated features.

    Edges are sampled so a fraction ``p_in`` stays within the node's community
    (community == label), giving both homophily (GNNs beat MLPs) and locality
    (partitioners find low cuts).  The graph is symmetrized.

    ``degree_skew`` > 0 switches to a degree-corrected SBM: per-node Pareto
    weights with shape ``1/degree_skew`` bias BOTH endpoints of every edge,
    producing the power-law degree profile + hub nodes of real web-scale
    graphs (ogbn-products' clustering is power-law, not uniform).  Hubs'
    neighborhoods span many partitions, so out-of-batch pulls become common
    and cache staleness actually bites — the adversarial regime the
    staleness-robustness suite needs (uniform SBMs make OB pulls rare by
    construction; VERDICT r3 weak #4).

    ``label_noise`` flips that fraction of OBSERVED labels (train, val and
    test alike) to a uniformly random class AFTER the graph/features were
    generated from the true communities — an accuracy ceiling of about
    ``1 - label_noise * (C-1)/C`` that no model can exceed, mirroring the
    label-ambiguity ceiling of real benchmarks (ogbn-products tops out at
    75-84% for every architecture).  Used by the hard presets to keep
    strong models in a non-saturated band: homophily (p_in) alone cannot —
    identity-propagation models (GCNII) have a sharp phase transition
    around p_in ~0.35-0.4 at degree 50 while GCN stays saturated at any
    p_in above it (docs/RESULTS.md r3 calibration)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)

    num_edges = int(num_nodes * avg_degree / 2)
    order = np.argsort(y, kind="stable")
    class_ptr = np.zeros(num_classes + 1, dtype=np.int64)
    class_ptr[1:] = np.cumsum(np.bincount(y, minlength=num_classes))
    intra = rng.random(num_edges) < p_in
    if degree_skew > 0.0:
        # degree-corrected: Pareto node weights bias both edge endpoints.
        # Inverse-CDF sampling over weight cumsums (global for src/inter
        # targets, per-class segments for intra targets) keeps this fully
        # vectorized at products scale.
        w = (1.0 - rng.random(num_nodes)) ** (-degree_skew)
        np.minimum(w, float(num_nodes) ** 0.5, out=w)  # cap extreme hubs
        w_sorted = w[order]
        cum_g = np.cumsum(w)
        src = np.searchsorted(cum_g, rng.random(num_edges) * cum_g[-1])
        src = np.minimum(src, num_nodes - 1).astype(np.int64)
        cum_c = np.cumsum(w_sorted)
        lo = class_ptr[y[src]]
        hi = class_ptr[y[src] + 1]
        base = np.where(lo > 0, cum_c[np.maximum(lo - 1, 0)], 0.0)
        span = cum_c[np.maximum(hi - 1, 0)] - base
        u = base + rng.random(num_edges) * np.maximum(span, 1e-12)
        dst_intra = order[np.minimum(np.searchsorted(cum_c, u), num_nodes - 1)]
        dst_inter = order[np.minimum(
            np.searchsorted(cum_c, rng.random(num_edges) * cum_c[-1]),
            num_nodes - 1)]
    else:
        src = rng.integers(0, num_nodes, size=num_edges)
        # same-community targets: pick random members of src's community
        cs = y[src]
        rand_in_class = class_ptr[cs] + rng.integers(0, np.maximum(class_ptr[cs + 1] - class_ptr[cs], 1))
        dst_intra = order[np.minimum(rand_in_class, num_nodes - 1)]
        dst_inter = rng.integers(0, num_nodes, size=num_edges)
    dst = np.where(intra, dst_intra, dst_inter)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    row = np.concatenate([src, dst])
    col = np.concatenate([dst, src])
    adj = CSRGraph.from_coo(row, col, num_nodes)

    # centers_seed pins the class geometry independently of the node/edge
    # draw, so several graphs (inductive splits) share one label distribution
    centers_rng = rng if centers_seed is None else np.random.default_rng(centers_seed)
    centers = centers_rng.normal(size=(num_classes, num_features)).astype(np.float32)
    x = centers[y] + feature_noise * rng.normal(size=(num_nodes, num_features)).astype(np.float32)

    perm = rng.permutation(num_nodes)
    n_train = int(train_frac * num_nodes)
    n_val = int(val_frac * num_nodes)
    train_mask = index2mask(perm[:n_train], num_nodes)
    val_mask = index2mask(perm[n_train : n_train + n_val], num_nodes)
    test_mask = index2mask(perm[n_train + n_val :], num_nodes)

    if label_noise > 0.0:
        flip = rng.random(num_nodes) < label_noise
        y = np.where(flip, rng.integers(0, num_classes, size=num_nodes),
                     y).astype(np.int32)

    if multilabel:
        y_ml = np.zeros((num_nodes, num_classes), dtype=np.float32)
        y_ml[np.arange(num_nodes), y] = 1.0
        extra = rng.integers(0, num_classes, size=num_nodes)
        y_ml[np.arange(num_nodes), extra] = 1.0
        y_out: np.ndarray = y_ml
    else:
        y_out = y

    data = GraphData(
        adj_t=adj, x=x, y=y_out,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
    )
    return data, num_features, num_classes


_SBM_PRESETS = {
    # name: (num_nodes, num_classes, num_features, avg_degree)
    "sbm-tiny": (400, 4, 16, 8.0),
    "sbm-small": (2_000, 8, 32, 10.0),
    "sbm-medium": (20_000, 16, 64, 12.0),
    "sbm-arxiv": (169_343, 40, 128, 13.7),  # ogbn-arxiv scale
    "sbm-products": (2_449_029, 47, 100, 50.0),  # ogbn-products scale
    "sbm-products-mid": (500_000, 47, 100, 50.0),
    "sbm-reddit": (232_965, 41, 602, 100.0),  # reddit scale
    "sbm-reddit-mid": (100_000, 41, 602, 100.0),
}

# calibrated non-saturated presets (full make_sbm kwargs; the JAX package's
# graph/datasets.py documents the calibration)
_SBM_HARD_PRESETS = {
    "sbm-arxiv-hard": dict(
        num_nodes=20_000, num_classes=16, num_features=64, avg_degree=12.0,
        p_in=0.4, feature_noise=6.0, train_frac=0.05,
    ),
    "sbm-products-hard": dict(
        num_nodes=50_000, num_classes=16, num_features=64, avg_degree=50.0,
        p_in=0.8, feature_noise=8.0, train_frac=0.05, label_noise=0.25,
    ),
    "sbm-products-hard-v4": dict(
        num_nodes=50_000, num_classes=64, num_features=16, avg_degree=50.0,
        p_in=0.8, feature_noise=8.0, train_frac=0.05, label_noise=0.15,
    ),
    "sbm-powerlaw-hard": dict(
        num_nodes=50_000, num_classes=16, num_features=64, avg_degree=30.0,
        p_in=0.55, feature_noise=10.0, train_frac=0.05, degree_skew=0.8,
    ),
}


# datasets whose val/test live on separate graphs (reference: get_ppi with
# split= returns disjoint graph sets, data.py:100-107), evaluated by a
# whole-graph forward (``train/trainer.py::full_graph_forward``)
INDUCTIVE_DATASETS = frozenset({"ppi", "sbm-ppi"})


def make_sbm_inductive(
    split: str = "train",
    num_nodes: int = 2000,
    num_classes: int = 8,
    num_features: int = 32,
    seed: int = 0,
    **kwargs,
) -> Tuple[GraphData, int, int]:
    """Synthetic inductive (PPI-style) dataset: three disjoint multilabel SBM
    graphs drawn from one shared class geometry (``centers_seed``), so a
    model trained on the train graph generalizes to the val/test graphs
    (reference data.py:100-107).  The val and test graphs have
    ``num_nodes // 4`` nodes (at least 50); the split's own mask is
    all-True (reference ``data[f'{split}_mask'] = ones``)."""
    sizes = {"train": num_nodes, "val": max(num_nodes // 4, 50),
             "test": max(num_nodes // 4, 50)}
    if split not in sizes:
        raise ValueError(f"split must be train/val/test, got {split!r}")
    offset = {"train": 0, "val": 1, "test": 2}[split]
    data, in_c, out_c = make_sbm(
        num_nodes=sizes[split], num_classes=num_classes,
        num_features=num_features, seed=seed * 3 + 1 + offset,
        centers_seed=seed, multilabel=True, **kwargs,
    )
    n = data.num_nodes
    masks = {s: np.full(n, s == split, dtype=bool) for s in sizes}
    data = dataclasses.replace(
        data, train_mask=masks["train"], val_mask=masks["val"],
        test_mask=masks["test"],
    )
    return data, in_c, out_c


def load_npz_dataset(root: str, name: str,
                     split: str | None = None) -> Tuple[GraphData, int, int]:
    """Load a preprocessed ``.npz`` dataset from ``{root}/{name}/data.npz``
    (or ``data_{split}.npz`` for the inductive per-split archives that
    ``convert_dataset --format ppi`` writes).  ``value``, where present,
    weighs the edges; a 2-D ``y`` is a multilabel f32 target."""
    fname = f"data_{split}.npz" if split else "data.npz"
    path = os.path.join(root, name, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Dataset archive not found: {path}. Real datasets must be "
            f"preprocessed to npz (rowptr,col,[value],x,y,train_mask,val_mask,"
            f"test_mask); no network egress is available to download them."
        )
    with np.load(path) as z:
        adj = CSRGraph(z["rowptr"], z["col"], z["value"] if "value" in z else None)
        y = z["y"]
        data = GraphData(
            adj_t=adj,
            x=z["x"].astype(np.float32),
            y=y.astype(np.int32) if y.ndim == 1 else y.astype(np.float32),
            train_mask=z["train_mask"].astype(bool),
            val_mask=z["val_mask"].astype(bool),
            test_mask=z["test_mask"].astype(bool),
        )
    return data, data.num_features, data.num_classes


def get_data(root: str, name: str, split: str = "train",
             **kwargs) -> Tuple[GraphData, int, int]:
    """Dataset dispatch (reference data.py:118-145): ``sbm-*`` names resolve
    to the synthetic generators (deterministic per seed), every other name
    to the archive under ``root``.  For the inductive datasets
    (``INDUCTIVE_DATASETS``) ``split`` selects which of the disjoint
    train/val/test graphs to load; other datasets ignore it."""
    name = name.lower()
    if name == "sbm-ppi":
        return make_sbm_inductive(split=split, **kwargs)
    if name in _SBM_PRESETS:
        n, c, f, d = _SBM_PRESETS[name]
        return make_sbm(num_nodes=n, num_classes=c, num_features=f, avg_degree=d, **kwargs)
    if name in _SBM_HARD_PRESETS:
        return make_sbm(**{**_SBM_HARD_PRESETS[name], **kwargs})
    if name == "sbm":
        return make_sbm(**kwargs)
    return load_npz_dataset(root, name,
                            split=split if name in INDUCTIVE_DATASETS else None)
