"""Locality-aware graph partitioning (numpy + the native library).

Port of ``incagg_gnn_tpu/graph/partition.py``: splits the node set into
``num_parts`` balanced clusters with few cut edges through the native C++
partitioner (``csrc/graph_ops.cpp``), then derives the clustered
permutation ``perm`` and cluster slice pointer ``ptr`` (reference
metis.py:14-40).  The JAX package's numpy partitioner stays there as the
test oracle.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from incagg_gnn_tpu_torch.graph.csr import CSRGraph
from incagg_gnn_tpu_torch.utils.native import native_lib


def ind2ptr(ind: np.ndarray, size: int) -> np.ndarray:
    """Convert a sorted cluster-assignment vector into slice pointers
    (reference: ``torch.ops.torch_sparse.ind2ptr``, metis.py:33)."""
    ind = np.asarray(ind)
    ptr = np.zeros(size + 1, dtype=np.int64)
    counts = np.bincount(ind, minlength=size)
    ptr[1:] = np.cumsum(counts)
    return ptr


def partition_graph(
    adj: CSRGraph,
    num_parts: int,
    seed: int = 0,
    refine_passes: int = 2,
    log: bool = False,
    method: str = "greedy",
) -> Tuple[np.ndarray, np.ndarray]:
    """Partition ``adj`` into ``num_parts`` balanced clusters.

    Returns ``(perm, ptr)``: ``perm`` sorts nodes so each cluster is a
    contiguous range, and ``ptr[k]:ptr[k+1]`` is cluster ``k``'s slice.
    ``method``: ``"greedy"`` (graph-growing + FM refinement) or
    ``"multilevel"`` (METIS-style V-cycle).
    """
    if method not in ("greedy", "multilevel"):
        raise ValueError(f"unknown partition method {method!r}")
    t = time.perf_counter()
    num_nodes = adj.num_nodes
    if num_parts <= 1:
        perm = np.arange(num_nodes, dtype=np.int64)
        ptr = np.array([0, num_nodes], dtype=np.int64)
        return perm, ptr

    cluster = native_lib().partition(adj.rowptr, adj.col, num_parts,
                                     refine_passes, seed,
                                     multilevel=method == "multilevel")
    perm = np.argsort(cluster, kind="stable").astype(np.int64)
    ptr = ind2ptr(cluster[perm], num_parts)
    if log:
        cut = edge_cut_fraction(adj, cluster)
        print(
            f"partition_graph: {num_parts} parts, cut={cut:.3f}, "
            f"[{time.perf_counter() - t:.2f}s]"
        )
    return perm, ptr


def edge_cut_fraction(adj: CSRGraph, cluster: np.ndarray) -> float:
    """Fraction of edges crossing cluster boundaries (partition quality)."""
    row = adj.row_indices().astype(np.int64)
    col = adj.col.astype(np.int64)
    if row.size == 0:
        return 0.0
    return float((cluster[row] != cluster[col]).mean())
