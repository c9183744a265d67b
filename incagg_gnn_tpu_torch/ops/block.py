"""Block-dense aggregation tier: dense ``[rb, 128]`` adjacency tiles + the
hybrid ELL/COO remainder.  Port of ``incagg_gnn_tpu/ops/block.py``.

After partition + permute, intra-cluster edges concentrate in dense blocks
of the adjacency.  Blocks holding at least a threshold of edges become dense
tiles that kernel A (``ops/kernels.py::block_spmm``) multiplies with the
matching 128-row block of ``x``; the other edges stay in a hybrid remainder.
Tiles are laid out row-block by row-block, ``LANES`` tiles per step, each
row-block's run padded with zero filler tiles (at least one step per
row-block, so every output row is written).

The builders return numpy containers bit-identical to the JAX package's
(bfloat16 tiles are held as their ``uint16`` bit patterns until
``.to(device)``).  Training uses :class:`BiBlockHybridAdj`, whose backward
is the same forward over the exact transpose pair.
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
    spmm_hybrid,
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


def _tile_np_dtype(a_dtype):
    return np.uint16 if a_dtype == BF16 else np.dtype(a_dtype)


def _tile_itemsize(a_dtype) -> int:
    return 2 if a_dtype == BF16 else np.dtype(a_dtype).itemsize


class BlockDense(NamedTuple):
    """Flat row-major dense-tile list, padded so every step's LANES tiles
    share one row-block (``brow_step``) and every row-block appears in at
    least one step (fillers are zero tiles and contribute nothing)."""

    a: np.ndarray  # [NB_pad, rb, B] tile values (0 = no edge / filler)
    brow_step: np.ndarray  # [S] int32 row-block id per step, sorted
    bcols: np.ndarray  # [LANES, S] int32 col-block id per step lane

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
) -> BlockHybridAdj:
    """Host-side conversion CSR -> dense tiles + hybrid remainder (the
    native two-phase build: count, lay out the padded runs, fill in place).

    ``a_dtype``: ``np.float32`` or :data:`BF16`.  ``nb_pad`` (total padded
    tile count, a multiple of LANES) keeps shapes static across a loader's
    batches; extra tiles are zero fillers on the last row-block.  Tiles are
    ``[rb_rows, 128]``; the dense output covers ``ceil(num_rows_pad /
    rb_rows) * rb_rows`` rows, sliced back to ``num_rows_pad``."""
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

    a = np.zeros((nb_pad, rb_rows, B), dtype=_tile_np_dtype(a_dtype))
    bcol_flat = np.zeros(nb_pad, dtype=np.int32)
    brow_flat = np.full(nb_pad, nrb - 1, dtype=np.int32)  # trailing fillers
    brow_flat[:total] = np.repeat(np.arange(nrb, dtype=np.int32), runs_pad)

    rp = np.zeros(num_rows_pad + 1, dtype=np.int64)
    rp[1 : r + 1] = np.cumsum(rem_deg)
    rp[r + 1 :] = rp[r]
    nrem = int(rp[r])
    r_col = np.empty(max(nrem, 1), dtype=np.int32)
    r_val = np.empty(max(nrem, 1), dtype=np.float32)
    lib.blocks_fill(rowptr, col, value, ncb, thresh, starts_pad, rp,
                    a, bcol_flat, r_col, r_val, rb_rows=rb_rows)
    r_col, r_val = r_col[:nrem], r_val[:nrem]

    s = nb_pad // LANES
    brow_step = brow_flat[::LANES].copy()
    bcols = bcol_flat.reshape(s, LANES).T.copy()
    rem = build_hybrid_adj(rp, r_col, r_val, num_rows_pad, num_cols_pad,
                           k=k, ovf_pad=ovf_pad, trash_col=trash_col,
                           ovf_inc=ovf_inc, bucket_ext=bucket_ext,
                           bucket_kink=bucket_kink)

    deg_full = np.zeros(num_rows_pad, dtype=np.float32)
    deg_full[:r] = deg
    return BlockHybridAdj(
        dense=BlockDense(a=a, brow_step=brow_step, bcols=bcols),
        rem=rem, deg=deg_full)


def spmm_block(adj: BlockHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation: kernel A over the dense tiles (``x`` cast
    to the tile dtype, f32 accumulation) + the hybrid remainder."""
    a_dtype = adj.dense.a.dtype
    out = block_spmm(adj.dense, x.to(a_dtype), adj.rem.num_rows).to(x.dtype)
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
) -> BiBlockHybridAdj:
    """Build the forward block-hybrid and its exact transpose.
    ``transpose`` optionally supplies a precomputed host ``(t_rowptr, t_col,
    t_val)``."""
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
                             bucket_kink=False, rb_rows=rb_rows)
    bwd = build_block_hybrid(t_rowptr, t_col, t_val, num_cols_pad,
                             num_rows_pad, thresh, a_dtype=a_dtype, k=k_t,
                             ovf_pad=ovf_pad_t, nb_pad=nb_pad_t,
                             ovf_inc=None if ovf_pad_t is None else False,
                             bucket_kink=False, rb_rows=rb_t)
    return BiBlockHybridAdj(fwd=fwd, bwd=bwd)
