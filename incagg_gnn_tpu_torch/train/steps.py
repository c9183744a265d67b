"""Training steps, GAS and Reverb/VR (port of
``incagg_gnn_tpu/train/steps.py``; reference: one ``mini_train`` iteration,
main.py:58-92): edge dropout, feature gather, forward, masked loss,
backward, clip + Adam.  GAS forwards write the history in place as they go."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.models.nn import edge_dropout
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.tables import DeviceTables


def masked_loss(out: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                multilabel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE (single-label) / BCE-with-logits (multi-label) over the
    masked rows, and the row count (reference: main.py:153-156, 80)."""
    m = mask.float()
    count = m.sum().clamp(min=1.0)
    if multilabel:
        per = F.binary_cross_entropy_with_logits(out, y, reduction="none").mean(-1)
    else:
        per = F.cross_entropy(out, y, reduction="none")
    return (per * m).sum() / count, m.sum()


def batch_inputs(batch, tables: DeviceTables):
    """Features of the batch's columns, labels and train mask of its rows."""
    x = tables.x.index_select(0, batch.n_id).float()
    y = tables.y.index_select(0, batch.push_idx)
    mask = tables.train_mask.index_select(0, batch.push_idx)
    rows = torch.arange(batch.push_idx.shape[0], device=mask.device)
    return x, y, mask & (rows < batch.batch_size)


def drop_edges(batch, generator: Optional[torch.Generator], p: float,
               weighted: bool):
    """The batch with DropEdge applied to its COO adjacency's values (the
    trainer sends ``edge_dropout > 0`` to the COO format)."""
    if p == 0.0:
        return batch
    adj = batch.adj
    vals = edge_dropout(adj.vals, p, True, generator, weighted)
    return batch._replace(adj=adj.with_values(vals))


def gas_loss(model, batch, tables: DeviceTables, hist_emb,
             generator: Optional[torch.Generator], multilabel: bool = False,
             use_aggregation: bool = True, aggregate_combined: bool = True,
             edge_dropout_p: float = 0.0,
             weighted_adj: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """GAS forward + masked loss (the forward pushes into ``hist_emb``)."""
    batch = drop_edges(batch, generator, edge_dropout_p, weighted_adj)
    x, y, mask = batch_inputs(batch, tables)
    out, aux = model.forward_gas(x, batch, hist_emb, generator, True,
                                 aggregate_combined=aggregate_combined,
                                 use_aggregation=use_aggregation)
    loss, n = masked_loss(out, y, mask, multilabel)
    return loss, n, aux


def vr_loss(model, batch, tables: DeviceTables, hist: HistoryState,
            generator: Optional[torch.Generator], multilabel: bool = False,
            drift_norm: int = 2, edge_dropout_p: float = 0.0,
            weighted_adj: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Reverb/VR forward on an in-batch-only batch + masked loss; the
    caches are read only."""
    batch = drop_edges(batch, generator, edge_dropout_p, weighted_adj)
    x, y, mask = batch_inputs(batch, tables)
    out, aux = model.forward_vr(x, batch, hist, generator, True, drift_norm)
    loss, n = masked_loss(out, y, mask, multilabel)
    return loss, n, aux


def train_step(opt: Optimizer, loss: torch.Tensor, n: torch.Tensor,
               aux: Dict) -> Dict:
    """Backward and one optimizer step; returns the step's metrics."""
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "num_train": n,
            **{k: v.detach() for k, v in aux.items()}}
