"""Aggregation front-end: dispatch on the adjacency format the loader built.

- ``HybridAdj`` — ELL+COO, forward-only (refresh sweeps, eval);
- ``BiHybridAdj`` — hybrid pair with the transpose backward (training);
- ``BlockHybridAdj`` — dense tiles + hybrid remainder, forward-only;
- ``BiBlockHybridAdj`` — dense tier forward and backward (training);
- ``PaddedAdj`` — sorted COO edge list + segment ops (``ops/spmm.py``), for
  edge dropout and the slot-exact IB-only ablation.

Max and min (PNA) run on the hybrid and COO formats; the dense tier cannot
express them and raises ``TypeError``, as the JAX package does.
"""

from __future__ import annotations

import torch

from incagg_gnn_tpu_torch.ops.block import (
    BiBlockHybridAdj,
    BlockHybridAdj,
    spmm_block,
    spmm_block_bi,
    spmm_block_bi_mean,
    spmm_block_mean,
)
from incagg_gnn_tpu_torch.ops.ell import (
    BiHybridAdj,
    HybridAdj,
    spmm_bi,
    spmm_bi_max,
    spmm_bi_mean,
    spmm_bi_min,
    spmm_hybrid,
    spmm_hybrid_max,
    spmm_hybrid_mean,
    spmm_hybrid_min,
)
from incagg_gnn_tpu_torch.ops.spmm import (
    PaddedAdj,
    spmm as spmm_coo,
    spmm_max as spmm_coo_max,
    spmm_mean as spmm_coo_mean,
    spmm_min as spmm_coo_min,
)

_SUM = {BiBlockHybridAdj: spmm_block_bi, BlockHybridAdj: spmm_block,
        BiHybridAdj: spmm_bi, HybridAdj: spmm_hybrid, PaddedAdj: spmm_coo}
_MEAN = {BiBlockHybridAdj: spmm_block_bi_mean, BlockHybridAdj: spmm_block_mean,
         BiHybridAdj: spmm_bi_mean, HybridAdj: spmm_hybrid_mean,
         PaddedAdj: spmm_coo_mean}
_MAX = {BiHybridAdj: spmm_bi_max, HybridAdj: spmm_hybrid_max, PaddedAdj: spmm_coo_max}
_MIN = {BiHybridAdj: spmm_bi_min, HybridAdj: spmm_hybrid_min, PaddedAdj: spmm_coo_min}


def _pick(table, adj):
    fn = table.get(type(adj))
    if fn is None:
        raise NotImplementedError(
            f"this aggregation over {type(adj).__name__} is not in the "
            f"PyTorch port yet (ROADMAP.md)")
    return fn


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    return _pick(_SUM, adj)(adj, x)


def spmm_mean(adj, x: torch.Tensor) -> torch.Tensor:
    return _pick(_MEAN, adj)(adj, x)


def spmm_reduce(adj, x: torch.Tensor, reduce: str) -> torch.Tensor:
    tables = {"sum": _SUM, "add": _SUM, "mean": _MEAN, "max": _MAX, "min": _MIN}
    if reduce not in tables:
        raise ValueError(f"unknown reduce: {reduce}")
    if reduce in ("max", "min") and isinstance(adj, (BlockHybridAdj, BiBlockHybridAdj)):
        raise TypeError("max aggregation is not expressible on the dense tier; "
                        "use the hybrid or COO formats for max/min models")
    return _pick(tables[reduce], adj)(adj, x)


def binarized_like(adj):
    return adj.binarized()


def edge_counts(adj, batch_size: int):
    """(#in-batch edges, #out-of-batch edges) as 0-dim tensors — the
    reference's per-step neighbor counts (base.py:369-378)."""
    if isinstance(adj, (BiBlockHybridAdj, BiHybridAdj)):
        adj = adj.fwd
    if isinstance(adj, BlockHybridAdj):
        real = adj.dense.vals != 0  # the tiles' nonzero cells
        d_ib = (real & (adj.dense.cols < batch_size)).sum()
        d_tot = real.sum()
        r_ib, r_ob = edge_counts(adj.rem, batch_size)
        return d_ib + r_ib, d_tot - d_ib + r_ob
    if isinstance(adj, HybridAdj):
        e_real = adj.ell_vals != 0
        e_ib = (e_real & (adj.ell_cols < batch_size)).sum()
        o_real = adj.ovf_vals != 0
        o_ib = (o_real & (adj.ovf_cols < batch_size)).sum()
        n_ib = e_ib + o_ib
        return n_ib, e_real.sum() + o_real.sum() - n_ib
    if isinstance(adj, PaddedAdj):
        real = adj.vals != 0
        ib = (real & (adj.cols < batch_size)).sum()
        return ib, real.sum() - ib
    _pick(_SUM, adj)  # raises for formats the port does not have
