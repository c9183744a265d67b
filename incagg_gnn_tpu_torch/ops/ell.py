"""Hybrid ELL + COO sparse format: builders (numpy) and aggregation (torch).

Port of ``incagg_gnn_tpu/ops/ell.py``.  Each row stores ``K`` column slots
(padded with a trash column of weight zero), so the aggregation is

    out = (x[ell_cols] * ell_vals[..., None]).sum(axis=1)       # [R, K, D] -> [R, D]

which kernel B (``ops/kernels.py::hybrid_spmm``) computes with the gather
fused into the reduce, over the real slots only.  Rows whose degree exceeds
``K`` spill to bucketed ELL extension levels (:class:`EllExt`) and a
row-sorted COO overflow, whose real entries kernel B adds in the same
launch through a row pointer (``HybridAdj.ovf_ptr``, port-only); a large
overflow is recast as binary incidence tiles (:class:`OvfIncidence`) that
kernel A multiplies.

The builders return the containers holding numpy arrays, bit-identical to
the JAX package's; ``.to(device)`` turns every array into a tensor.  The
cost-model constants are the JAX package's, so that both packages pick the
same layouts; they were fitted on another accelerator and are to be
measured again on this card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from incagg_gnn_tpu_torch.ops.kernels import (
    block_spmm, ell_spmm, hybrid_max, hybrid_max_bwd, hybrid_spmm, hybrid_spmm_table)
from incagg_gnn_tpu_torch.utils.native import native_lib


def tree_to(obj, device, pinned: bool = False):
    """Move a container tree to ``device``: numpy arrays become tensors
    (``uint16`` arrays hold bfloat16 bits and become bfloat16 tensors),
    tensors are moved, NamedTuples and tuples are rebuilt field by field;
    Python scalars stay as they are.  ``pinned``: numpy arrays are copied
    into pinned host memory and sent with ``non_blocking`` copies on the
    current CUDA stream (the caller orders the consumer after them)."""
    if obj is None or isinstance(obj, (int, float)):
        return obj
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(obj).view(np.int16)
                             if obj.dtype == np.uint16 else np.ascontiguousarray(obj))
        if pinned:
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        return t.view(torch.bfloat16) if obj.dtype == np.uint16 else t
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(v, device, pinned) for v in obj))
    if isinstance(obj, tuple):
        return tuple(tree_to(v, device, pinned) for v in obj)
    raise TypeError(f"cannot move {type(obj).__name__} to a device")


def tile_rows(rowptr, brow_step) -> int:
    """Tile height ``rb`` of a tile-CSR container: its ``rowptr`` covers
    ``nrb * rb`` output rows, and the last step belongs to row-block
    ``nrb - 1`` (every row-block has a step; trailing fillers take the
    last)."""
    return (int(rowptr.shape[0]) - 1) // (int(brow_step[-1]) + 1)


def densify_tiles(rowptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  brow_step: np.ndarray, bcols: np.ndarray) -> np.ndarray:
    """The dense tile list ``a [NB, rb, 128]`` of a host tile-CSR container,
    bit for bit as the JAX package builds it: entry ``(r, c)`` lands in the
    first tile of row-block ``r // rb`` whose column block is ``c // 128``
    (a real tile precedes its row-block's zero fillers).  For tests: the
    port never holds the cells."""
    lanes, s = bcols.shape
    n_out = int(rowptr.shape[0]) - 1
    cols, vals = cols[:rowptr[-1]], vals[:rowptr[-1]]  # past it: padding
    rb = tile_rows(rowptr, brow_step)
    brow_flat = np.repeat(brow_step.astype(np.int64), lanes)
    bcol_flat = bcols.T.reshape(-1).astype(np.int64)
    row = np.repeat(np.arange(n_out, dtype=np.int64), np.diff(rowptr))
    col = cols.astype(np.int64)
    ncb = int(max(bcol_flat.max(initial=0), col.max(initial=0) // _B)) + 1
    keys, first = np.unique(brow_flat * ncb + bcol_flat, return_index=True)
    key = (row // rb) * ncb + col // _B
    pos = np.searchsorted(keys, key)
    assert np.array_equal(keys[np.minimum(pos, keys.size - 1)], key), \
        "an entry lies outside the container's tiles"
    a = np.zeros((lanes * s, rb, _B), dtype=vals.dtype)
    a[first[pos], row % rb, col % _B] = vals
    return a


class OvfIncidence(NamedTuple):
    """Scatter-free overflow: ``out += S @ V`` with ``V[e] = val_e *
    x[col_e]`` (a gather) and ``S`` the 0/1 row incidence.  ``S`` is held as
    the nonzeros of the ``[128, 128]`` tiles the JAX package builds (each
    tile in one 128-row block; ``bcols`` is the identity: chunk j reads V
    block j), in the tile-CSR form of ``ops.block.BlockDense`` that kernel A
    multiplies: one entry ``(row, slot, 1)`` per overflow slot."""

    rowptr: np.ndarray  # [R_pad + 1] int32 entries per output row
    cols: np.ndarray  # [O] int32 V row (slot) of each entry, ascending per row
    vals: np.ndarray  # [O] float 1 per entry (the incidence)
    brow_step: np.ndarray  # [S] int32 output row-block per step
    bcols: np.ndarray  # [lanes, S] int32 V block per lane (identity layout)
    cols2: np.ndarray  # [NC_pad*B] int32 edge source; pad -> 0
    vals2: np.ndarray  # [NC_pad*B] float edge value; pad -> 0
    rows2: np.ndarray  # [NC_pad*B] int32 edge row; pad -> R_pad-1

    @property
    def rb(self) -> int:
        return tile_rows(self.rowptr, self.brow_step)

    def densify(self) -> np.ndarray:
        """The JAX package's ``a [NC_pad, 128, 128]`` (host containers)."""
        return densify_tiles(self.rowptr, self.cols, self.vals,
                             self.brow_step, self.bcols)

    def to(self, device) -> "OvfIncidence":
        return tree_to(self, device)


class EllExt(NamedTuple):
    """One bucketed-ELL extension level: ``Ki`` more slots for the rows
    whose degree spills past the running boundary.  ``rows`` is sorted;
    padding rows point at the trash row (R_pad-1) with zero vals."""

    rows: np.ndarray  # [Ri_pad] int32 sorted; padding -> R_pad-1
    cols: np.ndarray  # [Ri_pad, Ki] int32; padding -> trash col
    vals: np.ndarray  # [Ri_pad, Ki] float; padding -> 0

    def to(self, device) -> "EllExt":
        return tree_to(self, device)


class HybridAdj(NamedTuple):
    """ELL core + COO overflow (both statically shaped); ``deg`` is the
    true row degree (entry count).  ``ovf_ptr`` is the port's own field
    (the JAX package has none): row ``r``'s real overflow entries are
    ``ovf_ptr[r] .. ovf_ptr[r+1]``; the padding entries (all in row
    ``R_pad-1``) lie past ``ovf_ptr[-1]``, so no row owns them."""

    ell_cols: np.ndarray  # [R_pad, K] int32; padding -> trash col
    ell_vals: np.ndarray  # [R_pad, K] float32; padding -> 0
    ovf_rows: np.ndarray  # [O_pad] int32 sorted; padding -> R_pad-1
    ovf_cols: np.ndarray  # [O_pad] int32; padding -> trash col
    ovf_vals: np.ndarray  # [O_pad] float32; padding -> 0
    ovf_ptr: np.ndarray  # [R_pad + 1] int32 row pointer over the real entries
    deg: np.ndarray  # [R_pad] float32 true degrees
    ovf_inc: Optional[OvfIncidence] = None  # big-overflow tile path
    ext: Tuple[EllExt, ...] = ()  # bucketed-ELL extension levels

    #: fields the JAX package's ``HybridAdj`` does not have
    PORT_FIELDS = ("ovf_ptr",)

    @property
    def num_rows(self) -> int:
        return self.ell_cols.shape[0]

    def to(self, device) -> "HybridAdj":
        return tree_to(self, device)

    def binarized(self) -> "HybridAdj":
        """0/1 values in the value dtype (tensors)."""
        def b(v):
            return (v != 0).to(v.dtype)

        inc = self.ovf_inc
        if inc is not None:
            inc = inc._replace(vals2=b(inc.vals2))
        return self._replace(
            ell_vals=b(self.ell_vals), ovf_vals=b(self.ovf_vals), ovf_inc=inc,
            ext=tuple(e._replace(vals=b(e.vals)) for e in self.ext))

    def mask_in_batch(self, batch_size: int) -> "HybridAdj":
        """Keep only edges whose source column is in-batch (< batch_size),
        the IB-only ablation; degrees recounted over the kept entries
        (tensors).  Masked entries keep their slots with weight 0, so
        ``ovf_ptr`` stays right and kernel B skips them."""
        keep_e = (self.ell_cols < batch_size) & (self.ell_vals != 0)
        keep_o = (self.ovf_cols < batch_size) & (self.ovf_vals != 0)
        deg = keep_e.sum(dim=1).float().index_add(0, self.ovf_rows, keep_o.float())
        ext = []
        for e in self.ext:
            keep_x = (e.cols < batch_size) & (e.vals != 0)
            deg = deg.index_add(0, e.rows, keep_x.sum(dim=1).float())
            ext.append(e._replace(vals=torch.where(keep_x, e.vals, 0.0)))
        inc = self.ovf_inc
        if inc is not None:
            inc = inc._replace(vals2=torch.where(inc.cols2 < batch_size, inc.vals2, 0.0))
        return self._replace(
            ell_vals=torch.where(keep_e, self.ell_vals, 0.0),
            ovf_vals=torch.where(keep_o, self.ovf_vals, 0.0), deg=deg,
            ovf_inc=inc, ext=tuple(ext))

    def mask_rows(self, batch_size: int) -> "HybridAdj":
        """Zero every edge whose row id is >= batch_size: the transpose side
        of a pair's ``mask_in_batch`` (tensors).  ``deg`` is left as it is:
        the pair's backward never reads the transpose's degrees."""
        row_keep = torch.arange(self.num_rows, device=self.ell_vals.device) < batch_size
        inc = self.ovf_inc
        if inc is not None:
            inc = inc._replace(vals2=torch.where(inc.rows2 < batch_size, inc.vals2, 0.0))
        return self._replace(
            ell_vals=torch.where(row_keep[:, None], self.ell_vals, 0.0),
            ovf_vals=torch.where(row_keep.index_select(0, self.ovf_rows),
                                 self.ovf_vals, 0.0),
            ovf_inc=inc,
            ext=tuple(e._replace(vals=torch.where((e.rows < batch_size)[:, None],
                                                  e.vals, 0.0))
                      for e in self.ext))

    def with_scaled_values(self, keep_ell, keep_ovf) -> "HybridAdj":
        """Per-slot values in the forward layout (``[R_pad, K]``,
        ``[O_pad]``); the incidence tiles hold the old values, so they are
        dropped (the tail path computes the same sum)."""
        assert not self.ext, "per-slot rewrites assume a single-K ELL layout"
        return self._replace(ell_vals=keep_ell, ovf_vals=keep_ovf, ovf_inc=None)

    def cast_values(self, dtype) -> "HybridAdj":
        """Cast every value-carrying tensor, the incidence entries included."""
        inc = self.ovf_inc
        if inc is not None:
            inc = inc._replace(vals=inc.vals.to(dtype), vals2=inc.vals2.to(dtype))
        return self._replace(ell_vals=self.ell_vals.to(dtype),
                             ovf_vals=self.ovf_vals.to(dtype), ovf_inc=inc,
                             ext=tuple(e._replace(vals=e.vals.to(dtype))
                                       for e in self.ext))


#: see choose_k: extra per-edge slot-cost beyond ``coo_cost_ratio`` for
#: overflow edges past the locality knee
_OVF_LOCALITY_EXTRA = 7.0
_OVF_LOCALITY_EDGES = 200_000


def choose_k(degrees: np.ndarray, quantile: float = 0.98, align: int = 8,
             coo_cost_ratio: float = 3.0, locality_kink: bool = True) -> int:
    """ELL width minimizing the slot/overflow cost model: every row pays
    ``k`` slots, each overflow edge ``coo_cost_ratio`` slots (plus the
    locality term past ``_OVF_LOCALITY_EDGES`` when ``locality_kink``).
    Widths are multiples of ``align``; ``quantile`` caps the search."""
    if degrees.size == 0:
        return align
    hist = np.bincount(degrees)
    nz = int(degrees.size - hist[0])
    if nz == 0:
        return align
    cum_pos = np.cumsum(hist[1:])  # positive-degree rows with deg <= j+1
    qv = int(np.searchsorted(cum_pos, quantile * nz) + 1)
    dmax = len(hist) - 1
    kmax = min(qv * 4 + align, dmax)
    kmax = ((kmax + align - 1) // align) * align
    hist = np.concatenate([hist, np.zeros(max(0, kmax + 2 - len(hist)), hist.dtype)])
    # ovf(k) = Σ_d max(d-k,0)·hist[d] = Σ_{j>=k} #{deg > j}, via suffix sums
    gt = nz - np.cumsum(hist[1:])  # gt[j] = #rows with degree > j+1
    gt = np.concatenate([[nz], gt])  # now gt[j] = #rows with degree > j
    ovf = np.concatenate([np.cumsum(gt[::-1])[::-1], [0]])
    cands = np.arange(align, kmax + 1, align, dtype=np.int64)
    oc = ovf[cands].astype(np.float64)
    extra = (_OVF_LOCALITY_EXTRA if locality_kink else 0.0)
    cost = (degrees.size * cands + coo_cost_ratio * oc
            + extra * np.maximum(0.0, oc - _OVF_LOCALITY_EDGES))
    return int(cands[int(np.argmin(cost))])


#: cost of one extension-level row in ELL-slot units (its sorted index-add)
_EXT_ROW_COST = 3.0
#: fixed per-level cost in slot units (one more launch + pad waste)
_EXT_LEVEL_COST = 32768.0


def choose_k_levels(degrees: np.ndarray, align: int = 8,
                    coo_cost_ratio: float = 3.0,
                    locality_kink: bool = True,
                    max_levels: int = 3,
                    max_k: int = 96) -> Tuple[int, Tuple[int, ...]]:
    """Bucketed-ELL widths minimizing the slot/COO cost model: returns
    ``(k0, ext_widths)``, a base width every row pays plus up to
    ``max_levels`` extension widths paid only by rows whose degree exceeds
    the running boundary (brute force over aligned widths)."""
    if degrees.size == 0:
        return align, ()
    hist = np.bincount(degrees.astype(np.int64))
    dmax = len(hist) - 1
    kcap = min(max_k, ((dmax + align - 1) // align) * align)
    if kcap < align:
        return align, ()
    # gt[b] = #rows with degree > b ; ovf(b) = sum max(deg-b, 0) = suffix sum
    nz = int(degrees.size - hist[0])
    gt = np.concatenate([[nz], nz - np.cumsum(hist[1:])])
    gt = np.concatenate([gt, np.zeros(max(0, kcap + 2 - len(gt)), gt.dtype)])
    ovf = np.concatenate([np.cumsum(gt[::-1])[::-1], [0]])

    def ovf_cost(b):
        o = float(ovf[min(b, len(ovf) - 1)])
        extra = (_OVF_LOCALITY_EXTRA if locality_kink else 0.0)
        return coo_cost_ratio * o + extra * max(0.0, o - _OVF_LOCALITY_EDGES)

    cands = list(range(align, kcap + 1, align))
    r = float(degrees.size)
    best_c = [None]
    best_pick = [None]

    def rows_gt(b):
        return float(gt[min(b, len(gt) - 1)])

    def search(boundary, acc, widths, depth):
        c = acc + ovf_cost(boundary)
        if best_c[0] is None or c < best_c[0]:
            best_c[0] = c
            best_pick[0] = tuple(widths)
        if depth >= max_levels or rows_gt(boundary) <= 0:
            return
        for ki in cands:
            ri = rows_gt(boundary)
            search(boundary + ki,
                   acc + ri * ki + _EXT_ROW_COST * ri + _EXT_LEVEL_COST,
                   widths + [ki], depth + 1)

    for k0 in cands:
        search(k0, r * k0, [k0], 0)
    picked = best_pick[0]
    return int(picked[0]), tuple(int(k) for k in picked[1:])


def ell_buckets(degree_arrays, k: int = 8, ovf: int = 8,
                coo_cost_ratio: float = 3.0, locality_kink: bool = True):
    """Shared ELL/overflow bucket sizes covering every batch: grows ``(k,
    ovf)`` monotonically — the cost-model width over all batches, then the
    overflow slot count against that final ``k``, rounded up to 128."""
    arrays = list(degree_arrays)
    for deg in arrays:
        k = max(k, choose_k(deg, coo_cost_ratio=coo_cost_ratio,
                            locality_kink=locality_kink))
    need = 0
    for deg in arrays:
        need = max(need, int(np.maximum(deg - k, 0).sum()))
    return k, max(ovf, 8, -(-need // 128) * 128)


def overflow_ptr(ovf_rows: np.ndarray, n_real: int, num_rows: int) -> np.ndarray:
    """Row pointer ``[num_rows + 1]`` int32 over the first ``n_real``
    overflow entries (sorted by row); the padding entries after them
    belong to no row."""
    ptr = np.zeros(num_rows + 1, dtype=np.int32)
    np.cumsum(np.bincount(ovf_rows[:n_real], minlength=num_rows), out=ptr[1:])
    return ptr


#: row count below which bucketed-ELL auto never engages
_BUCKET_MIN_ROWS = 32768
#: overflow edge count above which one-off builds add the incidence tiles
_OVF_INC_MIN = 131072
_OVF_INC_LANES = 4
_B = 128  # tile edge (ops.block.B)


def _attach_ell_ext(base: HybridAdj, o: int, ext_widths, num_rows_pad: int,
                    trash_col: int, ovf_inc, ovf_inc_pad) -> HybridAdj:
    """Split the base build's (row-sorted) overflow into bucketed-ELL
    extension levels + a residual overflow (see :class:`EllExt`)."""
    orows = base.ovf_rows[:o]
    ocols = base.ovf_cols[:o]
    ovals = base.ovf_vals[:o]
    # position of each overflow edge within its row's overflow run
    first = np.concatenate([[0], np.flatnonzero(np.diff(orows)) + 1]) \
        if o else np.zeros(0, np.int64)
    rows_u = orows[first] if o else np.zeros(0, np.int32)
    cnt = np.diff(np.append(first, o))
    pos = np.arange(o) - np.repeat(first, cnt)

    exts = []
    prev = 0
    for ki in ext_widths:
        live = rows_u[cnt > prev]
        ri = int(live.size)
        ri_pad = max(8, ((ri + 7) // 8) * 8)
        rows_i = np.full(ri_pad, num_rows_pad - 1, np.int32)
        rows_i[:ri] = live
        cols_i = np.full((ri_pad, ki), trash_col, np.int32)
        vals_i = np.zeros((ri_pad, ki), ovals.dtype)
        sel = (pos >= prev) & (pos < prev + ki)
        rank = np.searchsorted(live, orows[sel])
        cols_i[rank, pos[sel] - prev] = ocols[sel]
        vals_i[rank, pos[sel] - prev] = ovals[sel]
        exts.append(EllExt(rows=rows_i, cols=cols_i, vals=vals_i))
        prev += ki

    sel = pos >= prev
    ro = int(sel.sum())
    opad = max(8, ((ro + 127) // 128) * 128)
    res_rows = np.full(opad, num_rows_pad - 1, np.int32)
    res_cols = np.full(opad, trash_col, np.int32)
    res_vals = np.zeros(opad, ovals.dtype)
    res_rows[:ro] = orows[sel]
    res_cols[:ro] = ocols[sel]
    res_vals[:ro] = ovals[sel]
    inc = None
    if ovf_inc is True or (ovf_inc is None and ro >= _OVF_INC_MIN):
        inc = build_ovf_incidence(res_rows, res_cols, res_vals, num_rows_pad,
                                  nc_pad=ovf_inc_pad)
    return base._replace(ovf_rows=res_rows, ovf_cols=res_cols,
                         ovf_vals=res_vals,
                         ovf_ptr=overflow_ptr(res_rows, ro, num_rows_pad),
                         ovf_inc=inc, ext=tuple(exts))


def build_hybrid_adj(
    rowptr: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows_pad: int,
    num_cols_pad: int,
    k: Optional[int] = None,
    ovf_pad: Optional[int] = None,
    trash_col: Optional[int] = None,
    ovf_inc: Optional[bool] = None,
    ovf_inc_pad: Optional[int] = None,
    bucket_ext: Optional[bool] = None,
    bucket_kink: bool = True,
) -> HybridAdj:
    """Host-side conversion CSR -> hybrid ELL/COO with static shapes.

    ``ovf_inc``: build the overflow-incidence tiles (None = auto: one-off
    builds, ``ovf_pad is None``, with at least ``_OVF_INC_MIN`` overflow
    slots; static loader builds opt in with ``ovf_inc=True``).
    ``bucket_ext``: bucketed-ELL extension levels when ``choose_k_levels``
    prefers them (None = auto: one-off builds of at least
    ``_BUCKET_MIN_ROWS`` rows).  ``bucket_kink`` forwards the overflow
    locality term (False for training chains)."""
    if ovf_inc is None and ovf_pad is not None:
        ovf_inc = False

    r = int(rowptr.shape[0] - 1)
    deg = np.diff(rowptr).astype(np.int64)
    if trash_col is None:
        trash_col = num_cols_pad - 1

    if bucket_ext is None:
        bucket_ext = (ovf_pad is None and k is None and r >= _BUCKET_MIN_ROWS
                      and col.size > 0)
    if bucket_ext and k is None:
        k0, ext_widths = choose_k_levels(deg, locality_kink=bucket_kink)
        if ext_widths:
            cap = int(np.maximum(deg - k0, 0).sum())
            base = build_hybrid_adj(
                rowptr, col, value, num_rows_pad, num_cols_pad, k=k0,
                ovf_pad=max(8, ((cap + 127) // 128) * 128),
                trash_col=trash_col, ovf_inc=False, bucket_ext=False)
            return _attach_ell_ext(base, cap, ext_widths, num_rows_pad,
                                   trash_col, ovf_inc, ovf_inc_pad)
        k = k0
    if k is None:
        k = choose_k(deg, locality_kink=bucket_kink)

    cap = int(np.maximum(deg - k, 0).sum())
    if ovf_pad is None:
        ovf_pad = max(8, ((cap + 127) // 128) * 128)
    assert cap <= ovf_pad, (cap, ovf_pad)
    ell_cols, ell_vals, orows, ocols, ovals, n_ovf = native_lib().csr_to_ell(
        rowptr, col, value, k, trash_col, ovf_pad, rows_alloc=num_rows_pad,
        ovf_row_fill=num_rows_pad - 1)
    deg_full = np.zeros(num_rows_pad, dtype=np.float32)
    deg_full[:r] = deg
    inc = None
    if ovf_inc is True or (ovf_inc is None and orows.shape[0] >= _OVF_INC_MIN):
        inc = build_ovf_incidence(orows, ocols, ovals, num_rows_pad,
                                  nc_pad=ovf_inc_pad)
    return HybridAdj(ell_cols=ell_cols, ell_vals=ell_vals, ovf_rows=orows,
                     ovf_cols=ocols, ovf_vals=ovals,
                     ovf_ptr=overflow_ptr(orows, n_ovf, num_rows_pad),
                     deg=deg_full, ovf_inc=inc)


def build_ovf_incidence(ovf_rows: np.ndarray, ovf_cols: np.ndarray,
                        ovf_vals: np.ndarray, num_rows_pad: int,
                        lanes: int = None,
                        nc_pad: Optional[int] = None) -> OvfIncidence:
    """Host-side build of the scatter-free overflow tiles (see
    :class:`OvfIncidence`).  ``ovf_rows`` must be sorted ascending; trailing
    padding rows (== num_rows_pad-1 with val 0) land in the last row block.
    ``nc_pad`` fixes the padded chunk count for static loader buckets."""
    lanes = _OVF_INC_LANES if lanes is None else lanes
    o = int(ovf_rows.shape[0])
    nrb = num_rows_pad // _B
    rb = ovf_rows.astype(np.int64) // _B  # sorted
    counts = np.bincount(rb, minlength=nrb)
    # chunks per row block: >=1 (kernel output coverage), padded to lanes
    runs = np.maximum(-(-counts // _B), 1)
    runs_pad = ((runs + lanes - 1) // lanes) * lanes
    total = int(runs_pad.sum())
    if nc_pad is None:
        nc_pad = total
    else:
        assert nc_pad >= total and nc_pad % lanes == 0, (nc_pad, total)
    starts_pad = np.concatenate([[0], np.cumsum(runs_pad)])[:-1]
    brow_flat = np.full(nc_pad, nrb - 1, dtype=np.int32)
    brow_flat[:total] = np.repeat(np.arange(nrb, dtype=np.int32), runs_pad)

    # slot of each edge: chunk = rb's chunk range + within//B
    grp_start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(o, dtype=np.int64) - grp_start[rb]
    chunk = starts_pad[rb] + within // _B
    pos = within % _B

    cols2 = np.zeros(nc_pad * _B, dtype=np.int32)
    vals2 = np.zeros(nc_pad * _B, dtype=np.float32)
    rows2 = np.full(nc_pad * _B, num_rows_pad - 1, dtype=np.int32)
    slot = chunk * _B + pos
    cols2[slot] = ovf_cols
    vals2[slot] = ovf_vals if ovf_vals is not None else 1.0
    rows2[slot] = ovf_rows
    s = nc_pad // lanes
    bcols = np.arange(nc_pad, dtype=np.int32).reshape(s, lanes).T.copy()
    # the incidence's nonzeros: one (row, slot) entry per overflow slot,
    # padding slots included; rows are sorted and slots ascend with them
    rowptr = np.zeros(num_rows_pad + 1, dtype=np.int32)
    rowptr[1:] = np.cumsum(np.bincount(ovf_rows, minlength=num_rows_pad))
    return OvfIncidence(rowptr=rowptr, cols=slot.astype(np.int32),
                        vals=np.ones(o, dtype=np.float32),
                        brow_step=brow_flat[::lanes].copy(), bcols=bcols,
                        cols2=cols2, vals2=vals2, rows2=rows2)


def spmm_hybrid(adj: HybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation: one launch of kernel B over the ELL core
    and each row's COO overflow tail, then each extension level (kernel B,
    added back with a sorted ``index_add``).  With incidence tiles the
    overflow goes to kernel A instead, after the ELL core and the levels."""
    inc = adj.ovf_inc
    if inc is None:
        out = hybrid_spmm(adj.ell_cols, adj.ell_vals, adj.ovf_ptr, adj.ovf_cols,
                          adj.ovf_vals, x)
    else:
        out = ell_spmm(adj.ell_cols, adj.ell_vals, x)
    for e in adj.ext:
        # padding rows point at the trash row with zero vals
        out = out.index_add(0, e.rows, ell_spmm(e.cols, e.vals, x))
    if inc is not None:
        v = x.index_select(0, inc.cols2) * inc.vals2[:, None]
        out = out + block_spmm(inc, v.to(inc.vals.dtype), adj.num_rows).to(x.dtype)
    return out


def spmm_hybrid_mean(adj: HybridAdj, x: torch.Tensor) -> torch.Tensor:
    return spmm_hybrid(adj, x) / adj.deg.clamp(min=1.0)[:, None]


def spmm_hybrid_table(adj: HybridAdj, table: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation of a global-column batch (its columns are
    rows of ``table``, a history cache in its storage dtype): one launch of
    kernel B's storage-dtype form over the ELL core and the overflow tail;
    returns f32.  The loader remaps single-K layouts only."""
    assert not adj.ext and adj.ovf_inc is None, \
        "global columns come from single-K loader builds"
    return hybrid_spmm_table(adj.ell_cols, adj.ell_vals, adj.ovf_ptr, adj.ovf_cols,
                             adj.ovf_vals, table)


def _single_k(adj: HybridAdj) -> None:
    assert not adj.ext, ("max aggregation expects single-K layouts "
                         "(bucketed builds are sum/mean block-tier remainders only)")


def spmm_hybrid_max(adj: HybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Max aggregation: one launch of kernel B's max form over the ELL
    core and each row's overflow tail (the incidence tiles, a sum-only
    recast of the same tail, are not read); rows of degree 0 give 0."""
    _single_k(adj)
    return hybrid_max(adj.ell_cols, adj.ell_vals, adj.ovf_ptr, adj.ovf_cols,
                      adj.ovf_vals, adj.deg, x)[0]


def spmm_hybrid_min(adj: HybridAdj, x: torch.Tensor) -> torch.Tensor:
    return -spmm_hybrid_max(adj, -x)


class BiHybridAdj(NamedTuple):
    """Forward + transposed hybrid pair: the backward ``dx = A^T @ g`` is
    another scatter-free hybrid aggregation over the host-built transpose,
    so backward costs the same as forward.

    ``t2f`` (built with ``with_perm=True``): for every transpose slot (the
    flattened transpose ELL ``[C_pad*K_t]``, then its overflow), the flat
    position of the same edge in the forward layout (the forward ELL
    ``[R_pad*K]``, then its overflow, padding included); -1 on padding.  It
    moves per-edge values computed in the forward layout (attention
    coefficients, score gradients) onto the transpose with a gather
    (``models/gat.py``)."""

    fwd: HybridAdj  # [R x C]
    bwd: HybridAdj  # [C x R]
    t2f: Optional[np.ndarray] = None  # [C_pad*K_t + O_t] int32, -1 = pad

    @property
    def num_rows(self) -> int:
        return self.fwd.num_rows

    @property
    def deg(self):
        return self.fwd.deg

    def to(self, device) -> "BiHybridAdj":
        return tree_to(self, device)

    def binarized(self) -> "BiHybridAdj":
        return BiHybridAdj(self.fwd.binarized(), self.bwd.binarized(), self.t2f)

    def mask_in_batch(self, batch_size: int) -> "BiHybridAdj":
        """IB-only ablation on both directions: the forward drops columns
        >= batch_size, the transpose the same edges, its rows >= batch_size."""
        return BiHybridAdj(self.fwd.mask_in_batch(batch_size),
                           self.bwd.mask_rows(batch_size), self.t2f)


class _SpmmBi(torch.autograd.Function):
    """``A @ x`` with the backward ``A^T @ g`` over the transpose format
    (``spmm_hybrid`` or ``ops.block.spmm_block``)."""

    @staticmethod
    def forward(ctx, x, fn, fwd, bwd):
        ctx.fn, ctx.bwd = fn, bwd
        return fn(fwd, x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(ctx.bwd, g.contiguous()), None, None, None


def spmm_bi(adj: BiHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Weighted-sum aggregation with the transpose-based backward."""
    return _SpmmBi.apply(x, spmm_hybrid, adj.fwd, adj.bwd)


def spmm_bi_mean(adj: BiHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Mean aggregation: the scale commutes through the transposed sum."""
    return spmm_bi(adj, x) / adj.fwd.deg.clamp(min=1.0)[:, None]


class _SpmmMaxBi(torch.autograd.Function):
    """Max aggregation with the scatter-free backward over the transpose
    (the JAX package's ``_spmm_max_bi`` custom VJP): the forward keeps the
    tie counts, and ``dx[c] = Σ_{(r,c)} [x[c] == out[r]] · g[r] / ties[r]``
    splits each row's cotangent evenly among the slots that reach its max,
    as autodiff of max does."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        _single_k(fwd)
        out, ties = hybrid_max(fwd.ell_cols, fwd.ell_vals, fwd.ovf_ptr, fwd.ovf_cols,
                               fwd.ovf_vals, fwd.deg, x,
                               want_ties=ctx.needs_input_grad[0])
        ctx.fwd, ctx.bwd = fwd, bwd
        if ties is not None:
            ctx.save_for_backward(x, out, ties)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, ties = ctx.saved_tensors
        b = ctx.bwd
        dx = hybrid_max_bwd(b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals,
                            g.contiguous(), ties, out, x, ctx.fwd.deg)
        return dx, None, None


def spmm_bi_max(adj: BiHybridAdj, x: torch.Tensor) -> torch.Tensor:
    """Max aggregation with the transpose-based backward."""
    return _SpmmMaxBi.apply(x, adj.fwd, adj.bwd)


def spmm_bi_min(adj: BiHybridAdj, x: torch.Tensor) -> torch.Tensor:
    return -spmm_bi_max(adj, -x)


def build_bi_hybrid_adj(
    rowptr: np.ndarray,
    col: np.ndarray,
    value: Optional[np.ndarray],
    num_rows_pad: int,
    num_cols_pad: int,
    k: Optional[int] = None,
    k_t: Optional[int] = None,
    ovf_pad: Optional[int] = None,
    ovf_pad_t: Optional[int] = None,
    with_perm: bool = False,
    bucket_ext: Optional[bool] = None,
) -> BiHybridAdj:
    """Build the forward hybrid and its transpose ([C x R], trash col at
    R_pad-1) from one local CSR block; the transpose's ELL is built from the
    forward CSR in one C++ pass.  ``with_perm`` adds the transpose slot
    permutation ``t2f`` (single-K layouts only).  ``bucket_ext`` (None =
    auto for one-off builds without ``with_perm``) adds bucketed-ELL levels
    on both directions."""
    if bucket_ext is None:
        bucket_ext = (k is None and k_t is None and ovf_pad is None
                      and ovf_pad_t is None and not with_perm
                      and rowptr.shape[0] - 1 >= _BUCKET_MIN_ROWS
                      and col.size > 0)
    if bucket_ext:
        fwd = build_hybrid_adj(rowptr, col, value, num_rows_pad,
                               num_cols_pad, bucket_ext=True,
                               bucket_kink=False)
        if fwd.ext:
            # transpose CSR on the host, then an independent bucketed build
            r = int(rowptr.shape[0] - 1)
            deg = np.diff(rowptr)
            rows = np.repeat(np.arange(r, dtype=np.int64), deg)
            order = np.lexsort((rows, col))
            t_cols = rows[order].astype(np.int32)
            t_vals = (value[order] if value is not None else None)
            t_deg = np.bincount(col.astype(np.int64),
                                minlength=num_cols_pad).astype(np.int64)
            t_rowptr = np.concatenate(([0], np.cumsum(t_deg)))
            bwd = build_hybrid_adj(
                t_rowptr, t_cols, t_vals, num_cols_pad, num_rows_pad,
                trash_col=num_rows_pad - 1, bucket_ext=True,
                bucket_kink=False)
            return BiHybridAdj(fwd=fwd, bwd=bwd)
        # level optimizer preferred single-K: keep that build
    else:
        fwd = build_hybrid_adj(rowptr, col, value, num_rows_pad,
                               num_cols_pad, k=k, ovf_pad=ovf_pad)
    k_fwd = int(fwd.ell_cols.shape[1])
    t_deg = np.bincount(col, minlength=num_cols_pad).astype(np.int64)
    if k_t is None:
        k_t = choose_k(t_deg)
    cap = int(np.maximum(t_deg - k_t, 0).sum())
    if ovf_pad_t is None:
        ovf_pad_t = max(8, ((cap + 127) // 128) * 128)
    assert cap <= ovf_pad_t, (cap, ovf_pad_t)
    ell_cols, ell_vals, orows, ocols, ovals, n_ovf, t2f = native_lib().csr_to_ell_t(
        rowptr, col, value, num_cols_pad, k_t, num_rows_pad - 1, ovf_pad_t,
        ovf_row_fill=num_cols_pad - 1, k_fwd=k_fwd,
        fwd_ovf_base=num_rows_pad * k_fwd, with_perm=with_perm and col.size > 0)
    if with_perm and col.size == 0:  # the JAX package's empty-block branch
        t2f = _transpose_perm_numpy(rowptr, col, k_fwd, num_rows_pad * k_fwd,
                                    k_t, num_cols_pad, ovf_pad_t)
    if t2f is not None:  # int32, as the JAX package holds it on the device
        t2f = t2f.astype(np.int32)
    bwd = HybridAdj(ell_cols=ell_cols, ell_vals=ell_vals, ovf_rows=orows,
                    ovf_cols=ocols, ovf_vals=ovals,
                    ovf_ptr=overflow_ptr(orows, n_ovf, num_cols_pad),
                    deg=t_deg.astype(np.float32))
    return BiHybridAdj(fwd=fwd, bwd=bwd, t2f=t2f)


def _transpose_perm_numpy(rowptr, col, k_fwd, fwd_ovf_base, k_t, c_pad,
                          ovf_pad_t) -> np.ndarray:
    """The transpose-slot -> forward-slot permutation ``t2f`` in numpy (the
    contract of the native ``csr_to_ell_t``'s)."""
    r = int(rowptr.shape[0] - 1)
    deg = np.diff(rowptr)
    e_row = np.repeat(np.arange(r, dtype=np.int64), deg)
    p_row = np.arange(col.shape[0]) - np.repeat(rowptr[:-1], deg)
    fwd_ovf_start = np.concatenate([[0], np.cumsum(np.maximum(deg - k_fwd, 0))])
    fwd_flat = np.where(p_row < k_fwd, e_row * k_fwd + p_row,
                        fwd_ovf_base + fwd_ovf_start[e_row] + (p_row - k_fwd))
    # transpose slot: a counting cursor per column in CSR edge order (a
    # stable sort by column keeps exactly that order within each column)
    order = np.argsort(col, kind="stable")
    j = col[order].astype(np.int64)
    t_deg = np.bincount(col, minlength=c_pad).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(t_deg)])[:-1]
    s_sorted = np.arange(j.shape[0]) - starts[j]
    t_ovf_start = np.concatenate([[0], np.cumsum(np.maximum(t_deg - k_t, 0))])
    bwd_flat = np.where(s_sorted < k_t, j * k_t + s_sorted,
                        c_pad * k_t + t_ovf_start[j] + (s_sorted - k_t))
    t2f = np.full(c_pad * k_t + max(ovf_pad_t, 1), -1, dtype=np.int64)
    t2f[bwd_flat] = fwd_flat[order]
    return t2f
