"""Host-side graph containers and transforms (numpy only).

A copy of ``incagg_gnn_tpu/graph/csr.py`` for the PyTorch port, whose
machine has no JAX: the same CSR container, ``gcn_norm`` and ``permute``,
giving bit-identical arrays.  The loader turns these arrays into padded
per-batch tensors.

All row/col indices are int32; values are float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency ``A^T`` (rows = aggregation targets).

    Mirrors the role of ``adj_t``'s CSR layout in the reference
    (torch_geometric_autoscale/loader.py:180), with ``value is None`` meaning
    an unweighted (binary) adjacency.
    """

    rowptr: np.ndarray  # [N+1] int64 (large graphs can exceed int32 nnz)
    col: np.ndarray  # [nnz] int32
    value: Optional[np.ndarray] = None  # [nnz] float32 or None

    def __post_init__(self):
        self.rowptr = np.asarray(self.rowptr, dtype=np.int64)
        self.col = np.asarray(self.col, dtype=np.int32)
        if self.value is not None:
            self.value = np.asarray(self.value, dtype=np.float32)
            assert self.value.shape == self.col.shape

    @property
    def num_nodes(self) -> int:
        return int(self.rowptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def row_indices(self) -> np.ndarray:
        """Expand rowptr into a per-edge row index array (COO rows)."""
        counts = np.diff(self.rowptr)
        return np.repeat(np.arange(self.num_nodes, dtype=np.int32), counts)

    def degrees(self) -> np.ndarray:
        """Out-degree per row (number of stored entries)."""
        return np.diff(self.rowptr).astype(np.int64)

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        num_nodes: int,
        value: Optional[np.ndarray] = None,
        coalesce: bool = True,
    ) -> "CSRGraph":
        """Build CSR from COO edges; sorts by (row, col) and optionally
        merges duplicate edges (summing values)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        if value is not None:
            value = np.asarray(value, dtype=np.float32)[order]
        if coalesce and row.size:
            keep = np.concatenate(([True], (row[1:] != row[:-1]) | (col[1:] != col[:-1])))
            if not keep.all():
                if value is not None:
                    seg = np.cumsum(keep) - 1
                    value = np.bincount(seg, weights=value).astype(np.float32)
                row, col = row[keep], col[keep]
        rowptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(rowptr, row + 1, 1)
        rowptr = np.cumsum(rowptr)
        return CSRGraph(rowptr, col.astype(np.int32), value)

    def to_coo(self):
        return self.row_indices(), self.col, self.value

    def set_diag(self, diag_value: float = 1.0) -> "CSRGraph":
        """Insert self-loops (reference: main.py:148, ``adj_t.set_diag()``).

        Existing diagonal entries are overwritten with ``diag_value`` when
        values are present; the structural pattern gains the full diagonal.
        """
        n = self.num_nodes
        row, col, val = self.to_coo()
        off = row != col
        row, col = row[off].astype(np.int64), col[off].astype(np.int64)
        if self.value is not None:
            val = val[off]
            drow = np.arange(n, dtype=np.int64)
            nrow = np.concatenate([row, drow])
            ncol = np.concatenate([col, drow])
            nval = np.concatenate([val, np.full(n, diag_value, np.float32)])
            return CSRGraph.from_coo(nrow, ncol, n, nval, coalesce=False)
        drow = np.arange(n, dtype=np.int64)
        return CSRGraph.from_coo(
            np.concatenate([row, drow]), np.concatenate([col, drow]), n, None, coalesce=False
        )

    def transpose(self, num_cols: Optional[int] = None) -> "CSRGraph":
        """CSR of A^T (swap row/col roles)."""
        nc = self.num_nodes if num_cols is None else num_cols
        row, col, val = self.to_coo()
        return CSRGraph.from_coo(col.astype(np.int64), row.astype(np.int64), nc, val, coalesce=False)

    def is_symmetric(self) -> bool:
        t = self.transpose()
        if not np.array_equal(t.rowptr, self.rowptr) or not np.array_equal(t.col, self.col):
            return False
        if (self.value is None) != (t.value is None):
            return False
        if self.value is not None and not np.allclose(t.value, self.value):
            return False
        return True


def gcn_norm(adj: CSRGraph, add_self_loops: bool = False) -> CSRGraph:
    """Symmetric GCN normalization ``D^-1/2 (A [+ I]) D^-1/2``.

    Matches ``torch_geometric.nn.conv.gcn_conv.gcn_norm`` as used by the
    reference (main.py:151, called with ``add_self_loops=False`` after an
    explicit ``set_diag``).  Degrees are computed from edge values when present
    (weighted degree), else from counts; isolated nodes get ``deg^-1/2 = 0``.
    """
    if add_self_loops:
        adj = adj.set_diag()
    row = adj.row_indices().astype(np.int64)
    col = adj.col.astype(np.int64)
    if adj.value is not None:
        deg = np.zeros(adj.num_nodes, dtype=np.float64)
        np.add.at(deg, row, adj.value.astype(np.float64))
    else:
        deg = np.diff(adj.rowptr).astype(np.float64)
    with np.errstate(divide="ignore"):
        dinv = 1.0 / np.sqrt(deg)
    dinv[~np.isfinite(dinv)] = 0.0
    base = adj.value.astype(np.float64) if adj.value is not None else 1.0
    value = (base * dinv[row] * dinv[col]).astype(np.float32)
    return CSRGraph(adj.rowptr.copy(), adj.col.copy(), value)


@dataclasses.dataclass
class GraphData:
    """Full-graph data bundle (reference analogue: torch_geometric Data with
    adj_t/x/y/masks, see data.py:118-145)."""

    adj_t: CSRGraph
    x: np.ndarray  # [N, F] float32
    y: np.ndarray  # [N] int32 (single-label) or [N, C] float32 (multi-label)
    train_mask: np.ndarray  # [N] bool
    val_mask: np.ndarray
    test_mask: np.ndarray
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return self.adj_t.num_nodes

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        if self.y.ndim == 1:
            return int(self.y.max()) + 1
        return int(self.y.shape[1])

    @property
    def multilabel(self) -> bool:
        return self.y.ndim > 1


def permute(data: GraphData, perm: np.ndarray) -> GraphData:
    """Permute all node-indexed tensors and the adjacency so that each cluster
    occupies a contiguous index range (reference: metis.py:43-63).

    ``perm[i]`` = old id of the node placed at new position ``i``.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = data.num_nodes
    assert perm.shape == (n,)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    row, col, val = data.adj_t.to_coo()
    new_adj = CSRGraph.from_coo(inv[row.astype(np.int64)], inv[col.astype(np.int64)], n, val, coalesce=False)

    def p(t: np.ndarray) -> np.ndarray:
        return t[perm] if t is not None and t.shape[0] == n else t

    return GraphData(
        adj_t=new_adj,
        x=p(data.x),
        y=p(data.y),
        train_mask=p(data.train_mask),
        val_mask=p(data.val_mask),
        test_mask=p(data.test_mask),
        extras={k: p(v) for k, v in data.extras.items()},
    )
