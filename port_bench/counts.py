"""The yardstick's arithmetic: the card's published peaks, the least time an
aggregation needs, and the structure of a batch counted from the graph.

An aggregation ``out[r] = reduce over the row's entries of x[c]`` over a
batch adjacency of ``nnz`` real entries, ``rows_in`` input rows and
``rows_out`` output rows of width ``D`` needs ``2·nnz·D`` operations and
``nnz·8 + rows_in·D·4 + rows_out·D·4`` bytes in f32 (a column index and a
value per entry, each input row read once, each output row written once).
Its bound is ``max(bytes / peak bandwidth, operations / peak f32 rate)``,
the bound of ``PERF.md``'s kernel table.  Everything is counted from the
batch's real entries, never from a kernel's format: ELL padding, tiles and
the overflow tail's padding are not work.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

#: published peaks by ``torch.cuda.get_device_name()``: bytes/s of HBM and
#: f32 FLOP/s outside the tensor cores (NVIDIA H100 SXM data sheet, dense)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not list."""
    return PEAKS.get(device_name)


def agg_work(nnz: int, rows_in: int, rows_out: int, d: int):
    """(operations, bytes) of one f32 aggregation."""
    return 2.0 * nnz * d, 8.0 * nnz + 4.0 * d * (rows_in + rows_out)


def agg_bound_s(nnz: int, rows_in: int, rows_out: int, d: int, pk: Dict[str, float]) -> float:
    """The least seconds one aggregation can take on a card of peaks ``pk``."""
    ops, nbytes = agg_work(nnz, rows_in, rows_out, d)
    return max(nbytes / pk["bytes_per_s"], ops / pk["flops_per_s"])


class BatchShape(NamedTuple):
    """A batch's structure in real entries: ``rows`` in-batch nodes,
    ``cols`` in-batch plus out-of-batch nodes (the one-hop neighbours),
    ``nnz`` entries of the in-batch rows over all columns, ``nnz_ib`` of
    them over in-batch columns."""

    rows: int
    cols: int
    nnz: int
    nnz_ib: int


def batch_shape(rowptr: np.ndarray, col: np.ndarray, nodes: np.ndarray,
                self_loops: bool) -> BatchShape:
    """The structure of the batch whose in-batch nodes are ``nodes`` (ids
    of the graph ``rowptr``/``col``), with a self-loop on every row where
    the configuration adds them."""
    nodes = np.asarray(nodes, dtype=np.int64)
    n = rowptr.shape[0] - 1
    starts, ends = rowptr[nodes], rowptr[nodes + 1]
    deg = ends - starts
    idx = np.repeat(starts - np.cumsum(np.concatenate([[0], deg[:-1]])), deg) + np.arange(
        int(deg.sum()))
    nbr = col[idx].astype(np.int64)
    inb = np.zeros(n, dtype=bool)
    inb[nodes] = True
    in_cols = inb[nbr]
    seen = inb.copy()
    seen[nbr] = True
    loops = len(nodes) if self_loops else 0
    return BatchShape(rows=len(nodes), cols=int(seen.sum()), nnz=int(deg.sum()) + loops,
                      nnz_ib=int(in_cols.sum()) + loops)
