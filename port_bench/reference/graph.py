"""The reference's adjacency: the graph with the configuration's transforms
(self-loops, symmetric normalization) and its aggregations, in plain
PyTorch.

``Adjacency`` holds the transformed graph as CSR tensors over the
graph's own node ids.  ``Sub`` is an aggregation's operand: entries
``(row, col, val)`` over ``rows`` output rows and ``cols`` input rows,
with each row's entry count ``deg`` (the binarized degree)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Sub(NamedTuple):
    row: torch.Tensor  # [E] int64, output row
    col: torch.Tensor  # [E] int64, input row
    val: torch.Tensor  # [E] f32
    rows: int
    cols: int
    deg: torch.Tensor  # [rows] f32 entry count


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


class Adjacency:
    """The graph ``rowptr``/``col`` (no self-loops, symmetric) with a
    self-loop on every node where ``loop``, its values the symmetric
    normalization ``d^-1/2 (A + I) d^-1/2`` where ``norm`` (computed in
    float64, stored in f32), else 1."""

    def __init__(self, rowptr: np.ndarray, col: np.ndarray, loop: bool, norm: bool, device):
        n = rowptr.shape[0] - 1
        rp = torch.as_tensor(rowptr, dtype=torch.int64, device=device)
        cl = torch.as_tensor(col, dtype=torch.int64, device=device)
        deg = rp[1:] - rp[:-1]
        ar = torch.arange(n, device=device)
        row = torch.repeat_interleave(ar, deg)
        if loop:
            row = torch.cat([row, ar])
            cl = torch.cat([cl, ar])
            order = torch.sort(row * n + cl).indices
            row, cl = row[order], cl[order]
            deg = deg + 1
        if norm:
            dinv = deg.to(torch.float64).rsqrt()
            dinv[deg == 0] = 0.0
            val = (dinv[row] * dinv[cl]).to(torch.float32)
        else:
            val = torch.ones(cl.shape[0], dtype=torch.float32, device=device)
        self.n = n
        self.device = torch.device(device)
        self.rowptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                                 torch.cumsum(deg, 0)])
        self.row, self.col, self.val = row, cl, val
        self.deg = deg.to(torch.float32)

    def full(self) -> Sub:
        """The whole graph as one operand."""
        return Sub(self.row, self.col, self.val, self.n, self.n, self.deg)

    def rows_of(self, nodes: torch.Tensor, cols: torch.Tensor, within: bool = False):
        """The operand of the batch whose output rows are ``nodes`` and whose
        input rows are ``cols`` (graph ids, in the order given; ``cols``
        starts with ``nodes``).  With ``within`` only the entries whose
        column is in ``cols`` are kept (an in-batch graph); otherwise every
        neighbour must be in ``cols``.  Returns ``(sub, faults)``: the
        neighbours missing from ``cols`` plus the entries of ``cols`` that
        are neither in-batch nor a neighbour (0 for a sound batch)."""
        starts = self.rowptr[nodes]
        deg = self.rowptr[nodes + 1] - starts
        e = int(deg.sum())
        idx = torch.repeat_interleave(starts - _excl_cumsum(deg), deg) + torch.arange(
            e, device=self.device)
        row = torch.repeat_interleave(torch.arange(nodes.shape[0], device=self.device), deg)
        local = torch.full((self.n,), -1, dtype=torch.int64, device=self.device)
        local[cols] = torch.arange(cols.shape[0], device=self.device)
        col = local[self.col[idx]]
        val = self.val[idx]
        present = col >= 0
        faults = 0
        if within:
            row, col, val = row[present], col[present], val[present]
        else:
            faults += int((~present).sum())
            used = torch.zeros(cols.shape[0], dtype=torch.bool, device=self.device)
            used[col[present]] = True
            used[: nodes.shape[0]] = True
            faults += int((~used).sum())
            row, col, val = row[present], col[present], val[present]
        cnt = torch.zeros(nodes.shape[0], dtype=torch.float32, device=self.device)
        cnt.index_add_(0, row, torch.ones_like(val))
        return Sub(row, col, val, nodes.shape[0], cols.shape[0], cnt), faults


def agg_sum(a: Sub, x: torch.Tensor, binary: bool = False) -> torch.Tensor:
    """``out[r] = Σ val · x[c]`` over the row's entries (``binary``: the
    values taken as 1)."""
    val = torch.ones_like(a.val) if binary else a.val
    m = torch.sparse_coo_tensor(torch.stack([a.row, a.col]), val, (a.rows, a.cols),
                                check_invariants=False)
    return torch.sparse.mm(m, x)


def agg_max(a: Sub, x: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """``out[r] = max x[c]`` over the row's entries, 0 on a row with none."""
    out = x.new_zeros((a.rows, x.shape[1]))
    if chunk is None:
        idx = a.row[:, None].expand(-1, x.shape[1])
        return out.scatter_reduce(0, idx, x.index_select(0, a.col), "amax",
                                  include_self=False)
    # no gradient here (the refresh): reduce a block of entries at a time
    out = x.new_full((a.rows, x.shape[1]), float("-inf"))
    for s in range(0, a.row.shape[0], chunk):
        r, c = a.row[s:s + chunk], a.col[s:s + chunk]
        out.scatter_reduce_(0, r[:, None].expand(-1, x.shape[1]), x.index_select(0, c),
                            "amax", include_self=True)
    return torch.where(a.deg[:, None] > 0, out, 0.0)


def agg_min(a: Sub, x: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """``out[r] = min x[c]`` over the row's entries, 0 on a row with none."""
    return -agg_max(a, -x, chunk)
