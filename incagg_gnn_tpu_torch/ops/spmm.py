"""COO aggregation: a padded edge list sorted by destination row, reduced
with gather + segment ops.

Port of ``incagg_gnn_tpu/ops/spmm.py``.  Every batch adjacency of this
format is a statically shaped edge list:

- ``rows[e]`` — local destination row id (ascending),
- ``cols[e]`` — local source column id,
- ``vals[e]`` — edge weight (1.0 for binary adjacencies, 0.0 for padding),

padded to the loader's edge bucket.  Padding edges carry ``vals == 0`` and
point at a zero trash column, so sum and mean need no mask; max and
softmax mask explicitly.

The JAX package computes these with XLA ``take`` + ``segment_*`` outside
any Pallas kernel; here they are plain PyTorch (``index_select``,
``index_add_``, ``scatter_reduce``), whose autograd gives the backward.
The format serves edge dropout (value-level masking) and the slot-exact
``aggregate_combined=false`` ablation.  The builder is numpy and returns a
numpy container; ``.to(device)`` turns it into tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from incagg_gnn_tpu_torch.ops.ell import tree_to


class PaddedAdj(NamedTuple):
    """A statically shaped (bipartite) sparse adjacency block; ``deg`` holds
    the true per-row entry count (mean reductions divide by it)."""

    rows: np.ndarray  # [E_pad] int32 ascending; padding -> R_pad-1
    cols: np.ndarray  # [E_pad] int32; padding -> the trash column
    vals: np.ndarray  # [E_pad] float32; padding -> 0
    deg: np.ndarray  # [R_pad] float32 true row degree

    @property
    def num_rows(self) -> int:
        return self.deg.shape[0]

    def to(self, device) -> "PaddedAdj":
        return tree_to(self, device)

    def with_values(self, vals: torch.Tensor) -> "PaddedAdj":
        return self._replace(vals=vals)

    def binarized(self) -> "PaddedAdj":
        """0/1 weights, keeping the padding structure (tensors)."""
        return self._replace(vals=(self.vals != 0).float())

    def mask_in_batch(self, batch_size: int) -> "PaddedAdj":
        """Keep only edges whose source column is in-batch (< batch_size),
        the IB-only ablation; degrees recounted over the kept entries."""
        keep = (self.cols < batch_size) & (self.vals != 0)
        deg = torch.zeros_like(self.deg).index_add_(0, self.rows.long(),
                                                    keep.float())
        return self._replace(vals=torch.where(keep, self.vals, 0.0), deg=deg)


def spmm(adj: PaddedAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted sum: ``out[r] = Σ_e vals[e] · x[cols[e]]``, ``[C, D] -> [R, D]``."""
    gathered = x.index_select(0, adj.cols) * adj.vals[:, None]
    out = x.new_zeros((adj.num_rows, x.shape[1]), dtype=gathered.dtype)
    return out.index_add(0, adj.rows, gathered)


def spmm_mean(adj: PaddedAdj, x: torch.Tensor) -> torch.Tensor:
    """Mean over the true (unpadded) neighbors."""
    return spmm(adj, x) / adj.deg.clamp(min=1.0)[:, None]


def _segment_max(src: torch.Tensor, rows: torch.Tensor, num_rows: int,
                 fill: float) -> torch.Tensor:
    """Per-row max of ``src [E, D]``; rows without entries hold ``fill``."""
    out = src.new_full((num_rows, src.shape[1]), fill)
    idx = rows.long()[:, None].expand(-1, src.shape[1])
    return out.scatter_reduce(0, idx, src, "amax", include_self=True)


def spmm_max(adj: PaddedAdj, x: torch.Tensor) -> torch.Tensor:
    """Max over the neighbors; padding (weight 0) is masked to the dtype's
    lowest value; rows without neighbors give 0."""
    neg = torch.finfo(x.dtype).min
    gathered = torch.where((adj.vals != 0)[:, None],
                           x.index_select(0, adj.cols), neg)
    out = _segment_max(gathered, adj.rows, adj.num_rows, neg)
    return torch.where(adj.deg[:, None] > 0, out, 0.0)


def spmm_min(adj: PaddedAdj, x: torch.Tensor) -> torch.Tensor:
    return -spmm_max(adj, -x)


def spmm_reduce(adj: PaddedAdj, x: torch.Tensor, reduce: str) -> torch.Tensor:
    if reduce in ("sum", "add"):
        return spmm(adj, x)
    if reduce == "mean":
        return spmm_mean(adj, x)
    if reduce == "max":
        return spmm_max(adj, x)
    if reduce == "min":
        return spmm_min(adj, x)
    raise ValueError(f"unknown reduce: {reduce}")


def segment_softmax(scores: torch.Tensor, rows: torch.Tensor, num_rows: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-destination-row softmax of edge scores ``[E, H] -> [E, H]``
    (GAT attention); invalid (padding) edges get weight 0, and a row whose
    scores are all masked takes its max as 0."""
    neg = torch.finfo(scores.dtype).min
    if valid is not None:
        scores = torch.where(valid[:, None], scores, neg)
    # rows without entries keep -inf, as XLA's segment_max leaves them
    row_max = _segment_max(scores, rows, num_rows, float("-inf"))
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    ex = torch.exp(scores - row_max.index_select(0, rows))
    if valid is not None:
        ex = torch.where(valid[:, None], ex, 0.0)
    denom = ex.new_zeros((num_rows, ex.shape[1])).index_add(0, rows, ex)
    return ex / denom.index_select(0, rows).clamp(min=1e-16)


def build_padded_adj(
    rowptr: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows_pad: int,
    num_cols_pad: int,
    num_edges_pad: int,
    trash_col: Optional[int] = None,
) -> PaddedAdj:
    """Host-side CSR block -> padded edge list (numpy).  Padding edges target
    ``trash_col`` (default: the last padded column, which the loader keeps
    at zero features) with weight 0, in row ``num_rows_pad - 1``."""
    e = int(col.shape[0])
    r = int(rowptr.shape[0] - 1)
    assert e <= num_edges_pad, (e, num_edges_pad)
    assert r <= num_rows_pad, (r, num_rows_pad)
    if trash_col is None:
        trash_col = num_cols_pad - 1
    out_rows = np.full(num_edges_pad, num_rows_pad - 1, dtype=np.int32)
    out_cols = np.full(num_edges_pad, trash_col, dtype=np.int32)
    out_vals = np.zeros(num_edges_pad, dtype=np.float32)
    out_rows[:e] = np.repeat(np.arange(r, dtype=np.int32), np.diff(rowptr))
    out_cols[:e] = col
    out_vals[:e] = value if value is not None else 1.0
    deg = np.zeros(num_rows_pad, dtype=np.float32)
    deg[:r] = np.diff(rowptr)
    return PaddedAdj(rows=out_rows, cols=out_cols, vals=out_vals, deg=deg)
