"""Aggregation front-end: dispatch on the adjacency format the loader built.

- ``HybridAdj`` — ELL+COO, forward-only (refresh sweeps, eval);
- ``BiHybridAdj`` — hybrid pair with the transpose backward (training);
- ``BlockHybridAdj`` — dense tiles + hybrid remainder, forward-only;
- ``BiBlockHybridAdj`` — dense tier forward and backward (training).

The COO format (``PaddedAdj``) of the JAX package is not ported yet.
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
    spmm_bi_mean,
    spmm_hybrid,
    spmm_hybrid_mean,
)

_SUM = {BiBlockHybridAdj: spmm_block_bi, BlockHybridAdj: spmm_block,
        BiHybridAdj: spmm_bi, HybridAdj: spmm_hybrid}
_MEAN = {BiBlockHybridAdj: spmm_block_bi_mean, BlockHybridAdj: spmm_block_mean,
         BiHybridAdj: spmm_bi_mean, HybridAdj: spmm_hybrid_mean}


def _pick(table, adj):
    fn = table.get(type(adj))
    if fn is None:
        raise NotImplementedError(
            f"aggregation over {type(adj).__name__}: the PyTorch port has the "
            f"block and hybrid formats only (COO is a later port step, "
            f"ROADMAP.md)")
    return fn


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    return _pick(_SUM, adj)(adj, x)


def spmm_mean(adj, x: torch.Tensor) -> torch.Tensor:
    return _pick(_MEAN, adj)(adj, x)


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
    _pick(_SUM, adj)  # raises for formats the port does not have
