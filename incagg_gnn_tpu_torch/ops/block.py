"""Block-dense aggregation tier: ``[rb, 128]`` adjacency tiles + the hybrid
ELL/COO remainder.  Port of ``incagg_gnn_tpu/ops/block.py``.

After partition + permute, intra-cluster edges concentrate in dense blocks
of the adjacency.  Blocks holding at least a threshold of edges become the
tiles of the dense tier; the other edges stay in a hybrid remainder.  The
plan (threshold, tile height, the tile list laid out row-block by
row-block, ``LANES`` tiles per step, zero filler tiles) is the JAX
package's, and picks the same tiles.  The port holds the tiles as their
nonzeros (:class:`BlockDense`, tile-CSR), which kernel A
(``ops/kernels.py::block_spmm``) multiplies with the rows of ``x`` they
name: the tiles of these graphs hold a few hundred nonzeros in tens of
thousands of cells.

The builders return numpy containers whose remainders and tile lists are
bit-identical to the JAX package's and whose ``densify()`` rebuilds its
tiles bit for bit (bfloat16 values are held as their ``uint16`` bit
patterns until ``.to(device)``).  Training uses :class:`BiBlockHybridAdj`,
whose backward is the same forward over the exact transpose pair.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from incagg_gnn_tpu_torch.ops.ell import (
    _OVF_LOCALITY_EDGES,
    _OVF_LOCALITY_EXTRA,
    HybridAdj,
    _SpmmBi,
    build_hybrid_adj,
    choose_k,
    densify_tiles,
    spmm_hybrid,
    tile_rows,
    tree_to,
)
from incagg_gnn_tpu_torch.ops.kernels import block_spmm
from incagg_gnn_tpu_torch.utils.native import native_lib

B = 128  # tile width (columns per tile, rows per x block)
LANES = 8  # tiles per step: the tile list layout the JAX package builds

# Cost-model constants of the JAX package (fitted on another accelerator)
# keep its values so that both packages pick the same tiles; they are to be
# measured again on this card before they decide anything here.
_HBM_GBPS = 819.0
_C_SLOT_NS = {4: 5.7, 2: 5.3}  # ELL per-slot cost by x itemsize
_COO_RATIO = 3.0  # overflow edge cost in ELL slots

#: ``a_dtype`` name for bfloat16 tiles (numpy has no bfloat16: the builder
#: stores the bit patterns as uint16)
BF16 = "bfloat16"


def _tile_itemsize(a_dtype) -> int:
    return 2 if a_dtype == BF16 else np.dtype(a_dtype).itemsize


class BlockDense(NamedTuple):
    """The dense tier's tiles, held as their nonzeros (tile-CSR).

    The tile list is the JAX package's: flat row-major, padded so every
    step's LANES tiles share one row-block (``brow_step``) and every
    row-block appears in at least one step (fillers are zero tiles).  Its
    cells are not held: ``rowptr``/``cols``/``vals`` list, for each of the
    ``nrb * rb`` dense output rows, the nonzero cells of that row over its
    row-block's tiles, in the order the tile product sums them (tile order,
    then in-tile column: ascending global column ``bcol * 128 + c``).
    Duplicate edges are summed into one cell as the JAX builder sums them,
    and cells that sum to exactly zero are dropped.  :meth:`densify`
    rebuilds the tiles.  A loader's batches pad ``cols``/``vals`` to one
    entry count (zeros past ``rowptr[-1]``, which no row owns), so that a
    training epoch's batches share one shape."""

    rowptr: np.ndarray  # [nrb * rb + 1] int32 entries per dense output row
    cols: np.ndarray  # [nnz_pad] int32 x row of each entry, ascending per row
    vals: np.ndarray  # [nnz_pad] cell value (f32, or bf16 bits as uint16)
    brow_step: np.ndarray  # [S] int32 row-block id per step, sorted
    bcols: np.ndarray  # [LANES, S] int32 col-block id per step lane

    @property
    def rb(self) -> int:
        return tile_rows(self.rowptr, self.brow_step)

    def densify(self) -> np.ndarray:
        """The JAX package's ``a [NB_pad, rb, 128]`` (host containers)."""
        return densify_tiles(self.rowptr, self.cols, self.vals,
                             self.brow_step, self.bcols)

    def to(self, device) -> "BlockDense":
        return tree_to(self, device)


class BlockHybridAdj(NamedTuple):
    """Dense tier + hybrid remainder (forward-only: refresh/eval sweeps)."""

    dense: BlockDense
    rem: HybridAdj  # remainder edges, same [R_pad x C_pad] index space
    deg: np.ndarray  # [R_pad] float32 FULL true degrees (rem.deg is partial)

    @property
    def num_rows(self) -> int:
        return self.rem.num_rows

    def to(self, device) -> "BlockHybridAdj":
        return tree_to(self, device)

    def binarized(self) -> "BlockHybridAdj":
        """0/1 cell values in the tile dtype, and a binarized remainder
        (tensors); ``deg`` keeps the entry counts."""
        vals = (self.dense.vals != 0).to(self.dense.vals.dtype)
        return self._replace(dense=self.dense._replace(vals=vals),
                             rem=self.rem.binarized())


def block_cost_ns(x_itemsize: int, a_itemsize: int, d_hint: int,
                  rb_rows: int = B) -> float:
    """Per-dense-tile cost model: the (A tile + x tile) bytes at the model
    bandwidth.  Taller tiles read one ``[128, D]`` x tile per ``rb`` rows."""
    return (rb_rows * B * a_itemsize + B * d_hint * x_itemsize) / _HBM_GBPS


def marginal_thresh(x_itemsize: int, a_itemsize: int, d_hint: int,
                    rb_rows: int = B) -> int:
    """Edges/block above which one dense tile beats its edges' ELL slots."""
    c_slot = _C_SLOT_NS.get(x_itemsize, 5.7)
    return max(8, int(np.ceil(
        block_cost_ns(x_itemsize, a_itemsize, d_hint, rb_rows) / c_slot)))


def _cost_ns(counts: np.ndarray, num_edges: int,
             thresh: int, deg: np.ndarray, x_itemsize: int, a_itemsize: int,
             d_hint: int, rb_rows: int = B) -> Tuple[float, float, int]:
    """(est. hybrid-only cost, est. block+remainder cost, dense edges)."""
    c_slot = _C_SLOT_NS.get(x_itemsize, 5.7)

    def hyb_cost(degs, e):
        if e == 0:
            return 0.0
        k = choose_k(degs)
        ovf = int(np.maximum(degs - k, 0).sum())
        extra = _OVF_LOCALITY_EXTRA * max(0, ovf - _OVF_LOCALITY_EDGES)
        return (degs.size * k + _COO_RATIO * ovf + extra) * c_slot

    base = hyb_cost(deg, num_edges)
    dense_mask = counts >= thresh
    nb = int(dense_mask.sum())
    e_dense = int(counts[dense_mask].sum())
    c_blk = block_cost_ns(x_itemsize, a_itemsize, d_hint, rb_rows)
    # remainder degrees approximated by a uniform shrink (conservative)
    if num_edges > 0 and e_dense > 0:
        rem_deg = np.floor(deg * (1.0 - e_dense / num_edges)).astype(np.int64)
    else:
        rem_deg = deg
    tiered = nb * c_blk + hyb_cost(rem_deg, num_edges - e_dense)
    return base, tiered, e_dense


def plan_block_tier(
    rowptr: np.ndarray,
    col: np.ndarray,
    num_cols_pad: int,
    x_itemsize: int = 4,
    a_itemsize: Optional[int] = None,
    d_hint: int = 256,
    min_gain: float = 0.08,
) -> Optional[int]:
    """Per-block edge threshold for 128-row tiles, or None when the cost
    model says the pure hybrid path is within ``min_gain`` of the tier."""
    plan = plan_block_tier_rb(rowptr, col, num_cols_pad, x_itemsize,
                              a_itemsize, d_hint, min_gain,
                              rb_candidates=(B,))
    return None if plan is None else plan[0]


def plan_block_tier_rb(
    rowptr: np.ndarray,
    col: np.ndarray,
    num_cols_pad: int,
    x_itemsize: int = 4,
    a_itemsize: Optional[int] = None,
    d_hint: int = 256,
    min_gain: float = 0.08,
    rb_candidates: Tuple[int, ...] = (128, 256, 512),
) -> Optional[Tuple[int, int]]:
    """Like :func:`plan_block_tier` but also chooses the tile height:
    ``(thresh, rb_rows)`` for the cheapest candidate, or None."""
    r = int(rowptr.shape[0] - 1)
    if col.size == 0 or r == 0:
        return None
    a_itemsize = x_itemsize if a_itemsize is None else a_itemsize
    deg = np.diff(rowptr).astype(np.int64)
    row = np.repeat(np.arange(r, dtype=np.int64), deg)
    ncb = num_cols_pad // B
    c64 = col.astype(np.int64)
    best = None  # (tiered_ns, thresh, rb)
    base_ns = None
    for rb in rb_candidates:
        key = (row // rb) * ncb + c64 // B
        counts = np.unique(key, return_counts=True)[1]
        thresh = marginal_thresh(x_itemsize, a_itemsize, d_hint, rb)
        base, tiered, e_dense = _cost_ns(
            counts, int(col.size), thresh, deg, x_itemsize, a_itemsize,
            d_hint, rb)
        base_ns = base
        if e_dense == 0:
            continue
        if best is None or tiered < best[0]:
            best = (tiered, thresh, rb)
    if best is None or best[0] > base_ns * (1.0 - min_gain):
        return None
    return best[1], best[2]


def measure_block_tier(
    rowptr: np.ndarray,
    col: np.ndarray,
    num_rows_pad: int,
    num_cols_pad: int,
    thresh: int,
    rb_rows: int = B,
) -> Tuple[int, np.ndarray]:
    """Pre-pass for static bucket sizing: (padded tile total that
    :func:`build_block_hybrid` will produce, remainder row degrees)."""
    nrb = -(-num_rows_pad // rb_rows)
    ncb = num_cols_pad // B
    deg = np.diff(rowptr).astype(np.int64)
    if col.size == 0:
        return nrb * LANES, deg  # one padded filler run per row-block
    _, ndense, rem_deg = native_lib().blocks_count(rowptr, col, ncb, thresh,
                                                   rb_rows=rb_rows)
    runs = np.zeros(nrb, dtype=np.int64)
    runs[: ndense.shape[0]] = ndense
    runs_pad = ((np.maximum(runs, 1) + LANES - 1) // LANES) * LANES
    return int(runs_pad.sum()), rem_deg


def build_block_hybrid(
    rowptr: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows_pad: int,
    num_cols_pad: int,
    thresh: int,
    a_dtype=np.float32,
    k: Optional[int] = None,
    ovf_pad: Optional[int] = None,
    nb_pad: Optional[int] = None,
    trash_col: Optional[int] = None,
    ovf_inc: Optional[bool] = False,
    bucket_ext: Optional[bool] = None,
    bucket_kink: bool = True,
    rb_rows: int = B,
    nnz_pad: Optional[int] = None,
) -> BlockHybridAdj:
    """Host-side conversion CSR -> dense tier (tile-CSR) + hybrid remainder.

    The edges go where the JAX package's native ``blocks_fill`` puts them,
    without its dense tile buffer (the port's ``tile_csr_fill``): an edge
    whose ``[rb_rows, 128]`` block holds at least ``thresh`` edges is a cell
    of that block's tile, any other edge stays in the remainder in CSR
    order.  A cell's value is the sum of its edges in CSR order, as
    ``blocks_fill`` adds them into a zeroed tile (f32 ``+=``, or bf16
    rounded to nearest even after each add); a cell whose bits come out
    zero is dropped (a bf16 sum may round to -0.0, which is kept so that
    :meth:`BlockDense.densify` rebuilds the tiles bit for bit).

    ``a_dtype``: ``np.float32`` or :data:`BF16`.  ``nb_pad`` (total padded
    tile count, a multiple of LANES) keeps the tile list static across a
    loader's batches; extra tiles are zero fillers on the last row-block.
    The dense output covers ``ceil(num_rows_pad / rb_rows) * rb_rows``
    rows, sliced back to ``num_rows_pad``.  ``nnz_pad`` (at least the dense
    tier's edge count) pads the tile-CSR entries with zeros past
    ``rowptr[-1]``."""
    assert num_rows_pad % B == 0 and num_cols_pad % B == 0
    r = int(rowptr.shape[0] - 1)
    nrb = -(-num_rows_pad // rb_rows)
    ncb = num_cols_pad // B
    deg = np.diff(rowptr).astype(np.int64)
    lib = native_lib()

    _, ndense, rem_deg = lib.blocks_count(rowptr, col, ncb, thresh,
                                          rb_rows=rb_rows)
    runs = np.zeros(nrb, dtype=np.int64)
    runs[: ndense.shape[0]] = ndense
    runs_pad = ((np.maximum(runs, 1) + LANES - 1) // LANES) * LANES
    total = int(runs_pad.sum())
    if nb_pad is not None:
        assert nb_pad >= total and nb_pad % LANES == 0, (nb_pad, total)
    else:
        nb_pad = total
    starts_pad = np.concatenate([[0], np.cumsum(runs_pad)])[:-1]
    bcol_flat = np.zeros(nb_pad, dtype=np.int32)  # fillers read block 0
    brow_flat = np.full(nb_pad, nrb - 1, dtype=np.int32)  # trailing fillers
    brow_flat[:total] = np.repeat(np.arange(nrb, dtype=np.int32), runs_pad)

    rp = np.zeros(num_rows_pad + 1, dtype=np.int64)
    rp[1 : r + 1] = np.cumsum(rem_deg)
    rp[r + 1 :] = rp[r]
    nrem = int(rp[r])
    ent_rp = np.zeros(r + 1, dtype=np.int64)  # room: each row's tile edges
    ent_rp[1:] = np.cumsum(deg - rem_deg)
    r_col = np.empty(max(nrem, 1), dtype=np.int32)
    r_val = np.empty(max(nrem, 1), dtype=np.float32)
    e_col = np.empty(max(int(ent_rp[r]), 1), dtype=np.int32)
    e_val = np.empty(e_col.shape[0], dtype=np.uint16 if a_dtype == BF16
                     else np.dtype(a_dtype))
    nnz, e_rp = lib.tile_csr_fill(rowptr, col, value, ncb, thresh, starts_pad,
                                  rp, ent_rp, bcol_flat, r_col, r_val, e_col,
                                  e_val, rb_rows=rb_rows)
    assert nnz < 2 ** 31, "tile-CSR entries overflow int32"
    d_rowptr = np.full(nrb * rb_rows + 1, nnz, dtype=np.int32)
    d_rowptr[: r + 1] = e_rp

    s = nb_pad // LANES
    brow_step = brow_flat[::LANES].copy()
    bcols = bcol_flat.reshape(s, LANES).T.copy()
    rem = build_hybrid_adj(rp, r_col[:nrem], r_val[:nrem], num_rows_pad,
                           num_cols_pad, k=k, ovf_pad=ovf_pad,
                           trash_col=trash_col, ovf_inc=ovf_inc,
                           bucket_ext=bucket_ext, bucket_kink=bucket_kink)

    deg_full = np.zeros(num_rows_pad, dtype=np.float32)
    deg_full[:r] = deg
    n_ent = nnz if nnz_pad is None else nnz_pad
    assert nnz <= n_ent, (nnz, n_ent)
    cols = np.zeros(n_ent, np.int32)
    vals = np.zeros(n_ent, e_val.dtype)
    cols[:nnz], vals[:nnz] = e_col[:nnz], e_val[:nnz]
    return BlockHybridAdj(
        dense=BlockDense(rowptr=d_rowptr, cols=cols, vals=vals, brow_step=brow_step,
                         bcols=bcols),
        rem=rem, deg=deg_full)


def nonempty_tiles(dense) -> int:
    """Tiles holding a nonzero cell, of a tile-CSR container (``BlockDense``
    or ``OvfIncidence``, numpy or tensors on any device)."""
    d = tree_to(dense, "cpu")
    rowptr = d.rowptr.long()
    n = int(rowptr[-1])  # past it: padding
    live = d.vals[:n] != 0
    if not bool(live.any()):
        return 0
    rows = torch.repeat_interleave(torch.arange(rowptr.numel() - 1), rowptr.diff())
    cb = d.cols[:n].long() // B
    key = (rows // d.rb) * (int(cb.max()) + 1) + cb
    return int(torch.unique(key[live]).numel())


def spmm_block(adj: BlockHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation: kernel A over the dense tier (``x`` cast
    to the tile dtype, f32 accumulation) + the hybrid remainder."""
    out = block_spmm(adj.dense, x.to(adj.dense.vals.dtype),
                     adj.rem.num_rows).to(x.dtype)
    return out + spmm_hybrid(adj.rem, x)


def spmm_block_mean(adj: BlockHybridAdj, x: torch.Tensor) -> torch.Tensor:
    return spmm_block(adj, x) / adj.deg.clamp(min=1.0)[:, None]


class BiBlockHybridAdj(NamedTuple):
    """Forward + transposed block-hybrid pair, the dense tier's training
    format.  Block (i, j) of A holds exactly the edges of block (j, i) of
    A^T, so the transpose built with the same per-block threshold densifies
    exactly the transposed tiles and the remainders are mutual transposes:
    the backward ``A^T @ g`` is exact."""

    fwd: BlockHybridAdj  # [R x C]
    bwd: BlockHybridAdj  # [C x R]

    @property
    def num_rows(self) -> int:
        return self.fwd.num_rows

    @property
    def deg(self):
        return self.fwd.deg

    def to(self, device) -> "BiBlockHybridAdj":
        return tree_to(self, device)

    def binarized(self) -> "BiBlockHybridAdj":
        return BiBlockHybridAdj(self.fwd.binarized(), self.bwd.binarized())


def spmm_block_bi(adj: BiBlockHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation, dense tier forward AND backward (the
    backward is :func:`spmm_block` over the transpose pair)."""
    return _SpmmBi.apply(x, spmm_block, adj.fwd, adj.bwd)


def spmm_block_bi_mean(adj: BiBlockHybridAdj, x: torch.Tensor) -> torch.Tensor:
    return spmm_block_bi(adj, x) / adj.fwd.deg.clamp(min=1.0)[:, None]


def transpose_csr_host(rowptr: np.ndarray, col: np.ndarray,
                       value: Optional[np.ndarray], num_cols: int):
    """Host CSR transpose (native counting sort; numpy for no edges)."""
    if col.size:
        return native_lib().transpose_csr(rowptr, col, value, num_cols)
    t_rowptr = np.zeros(num_cols + 1, dtype=np.int64)
    t_val = np.zeros(0, np.float32) if value is not None else None
    return t_rowptr, np.zeros(0, np.int32), t_val


def build_bi_block_hybrid(
    rowptr: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows_pad: int,
    num_cols_pad: int,
    thresh: int,
    a_dtype=np.float32,
    k: Optional[int] = None,
    k_t: Optional[int] = None,
    ovf_pad: Optional[int] = None,
    ovf_pad_t: Optional[int] = None,
    nb_pad: Optional[int] = None,
    nb_pad_t: Optional[int] = None,
    transpose: Optional[tuple] = None,
    rb_rows: int = B,
    rb_rows_t: Optional[int] = None,
    nnz_pad: Optional[int] = None,
    nnz_pad_t: Optional[int] = None,
) -> BiBlockHybridAdj:
    """Build the forward block-hybrid and its exact transpose.
    ``transpose`` optionally supplies a precomputed host ``(t_rowptr, t_col,
    t_val)``; ``nnz_pad``/``nnz_pad_t`` pad each side's tile entries."""
    # bi remainders size without the overflow-locality kink; one-off builds
    # (no static pads) leave k=None for build_hybrid_adj's level optimizer
    one_off = ovf_pad is None and ovf_pad_t is None
    rb_t = rb_rows if rb_rows_t is None else rb_rows_t
    if k is None and not one_off:
        _, rem_deg = measure_block_tier(rowptr, col, num_rows_pad,
                                        num_cols_pad, thresh,
                                        rb_rows=rb_rows)
        k = choose_k(rem_deg, locality_kink=False)
    if transpose is None:
        transpose = transpose_csr_host(rowptr, col, value, num_cols_pad)
    t_rowptr, t_col, t_val = transpose
    if k_t is None and not one_off:
        _, rem_deg_t = measure_block_tier(t_rowptr, t_col, num_cols_pad,
                                          num_rows_pad, thresh,
                                          rb_rows=rb_t)
        k_t = choose_k(rem_deg_t, locality_kink=False)
    fwd = build_block_hybrid(rowptr, col, value, num_rows_pad, num_cols_pad,
                             thresh, a_dtype=a_dtype, k=k, ovf_pad=ovf_pad,
                             nb_pad=nb_pad,
                             ovf_inc=None if ovf_pad is None else False,
                             bucket_kink=False, rb_rows=rb_rows, nnz_pad=nnz_pad)
    bwd = build_block_hybrid(t_rowptr, t_col, t_val, num_cols_pad,
                             num_rows_pad, thresh, a_dtype=a_dtype, k=k_t,
                             ovf_pad=ovf_pad_t, nb_pad=nb_pad_t,
                             ovf_inc=None if ovf_pad_t is None else False,
                             bucket_kink=False, rb_rows=rb_t, nnz_pad=nnz_pad_t)
    return BiBlockHybridAdj(fwd=fwd, bwd=bwd)
