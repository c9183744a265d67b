"""One-hop subgraph extraction with local relabeling (native library).

Port of ``incagg_gnn_tpu/graph/relabel.py`` (reference
csrc/cpu/relabel_cpu.cpp):

- ``relabel_one_hop``: induced one-hop subgraph of the batch nodes ``idx``;
  rows = the ``idx`` nodes, columns relabeled so in-batch (IB) nodes keep
  their position in ``idx`` and out-of-batch (OB) neighbors follow in
  first-seen order.  Returns ``(rowptr, col, value, n_id)`` with
  ``n_id = idx ++ ob_ids``.
- ``relabel_one_hop_within_batch``: the same with OB edges dropped — the
  IB-only graph of Reverb/VR training batches.
- ``sample_neighbors``: each row of a relabeled batch capped at
  ``num_neighbors`` entries (neighbor-sampling, ``ns``, training batches).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from incagg_gnn_tpu_torch.graph.csr import CSRGraph
from incagg_gnn_tpu_torch.utils.native import native_lib

RelabelOut = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], np.ndarray]


def relabel_one_hop(adj: CSRGraph, idx: np.ndarray, bipartite: bool = True) -> RelabelOut:
    """Full IB+OB relabel. ``n_id[: len(idx)] == idx``; OB ids follow in
    first-seen order."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    rowptr, col, value, n_id = native_lib().relabel_one_hop(
        adj.rowptr, adj.col, adj.value, idx)
    if not bipartite:
        extra = n_id.shape[0] - (rowptr.shape[0] - 1)
        if extra > 0:
            rowptr = np.concatenate([rowptr, np.full(extra, rowptr[-1], dtype=np.int64)])
    return rowptr, col, value, n_id


def relabel_one_hop_within_batch(
    adj: CSRGraph, idx: np.ndarray, bipartite: bool = True
) -> RelabelOut:
    """IB-only relabel: drops all edges touching out-of-batch nodes
    (reference: relabel_cpu.cpp:143-155)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    return native_lib().relabel_one_hop_within_batch(
        adj.rowptr, adj.col, adj.value, idx)


def sample_neighbors(rowptr: np.ndarray, col: np.ndarray, value: Optional[np.ndarray],
                     num_neighbors: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Cap each row at ``num_neighbors`` uniformly sampled entries, without
    replacement, in their order (the JAX package's native sampler, so the
    draws are its draws for the same ``seed``; a fixed reimplementation of
    the reference's ``sample_neighbors``, loader.py:32-93).  A negative
    ``num_neighbors`` keeps every entry."""
    if num_neighbors < 0:
        return rowptr, col, value
    return native_lib().sample_neighbors(rowptr, col, value, num_neighbors, seed)
