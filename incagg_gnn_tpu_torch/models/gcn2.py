"""GCNII (GCN2) with GAS and Reverb/VR training (reference: models/gcn2.py).

Port of ``incagg_gnn_tpu/models/gcn2.py``.  Layer math (PyG
``GCN2Conv(normalize=False)``, the initial-residual + identity-mapping model
of Chen et al. 2020)::

    x̂   = (1 − α) · (A @ x)           # propagate phase
    x̂0  = α · x_0
    shared_weights:   out = (1−β_l)(x̂ + x̂0) + β_l (x̂ + x̂0) W₁
    unshared:         out = (1−β_l) x̂ + β_l x̂ W₁ + (1−β_l) x̂0 + β_l x̂0 W₂
    β_l = log(θ/(l+1) + 1)

:func:`gcn2_update` is the post-propagation phase; the VR forward
substitutes the incremental aggregation ``A_ib @ (x − M_in) + M_ag`` for the
propagate phase.  ``x_0 = relu(lins[0](x))`` is cached as ``M_in[0]``, and
the refresh sweep reads it back for the layers after 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.models.base import BaseConfig, ScalableGNN, valid_rows
from incagg_gnn_tpu_torch.models.nn import Linear, MaskedBatchNorm, dropout, pad_rows
from incagg_gnn_tpu_torch.ops.agg import edge_counts, spmm


@dataclasses.dataclass(frozen=True)
class GCN2Config(BaseConfig):
    alpha: float = 0.1
    theta: float = 0.5
    shared_weights: bool = True
    drop_input: bool = True
    batch_norm: bool = False
    residual: bool = False


class GCN2Conv(nn.Module):
    """The weights of one GCN2Conv: ``w1`` and, unshared, ``w2``; both
    ``[hidden, hidden]``, glorot, no bias."""

    def __init__(self, dim: int, shared_weights: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w1 = Linear(dim, dim, bias=False, init="glorot", generator=generator).w
        self.w2 = None
        if not shared_weights:
            self.w2 = Linear(dim, dim, bias=False, init="glorot", generator=generator).w


def gcn2_update(conv: GCN2Conv, cfg: GCN2Config, layer: int, x_hat: torch.Tensor,
                x0: torch.Tensor) -> torch.Tensor:
    """Post-propagation phase of GCN2Conv: identity-mix with ``x0`` (cropped
    to the aggregated rows) and weight transform.  ``x_hat`` is ``A @ x``."""
    beta = math.log(cfg.theta / (layer + 1) + 1.0)
    x_hat = (1.0 - cfg.alpha) * x_hat
    x0 = cfg.alpha * x0[: x_hat.shape[0]]
    if cfg.shared_weights:
        s = x_hat + x0
        return (1.0 - beta) * s + beta * (s @ conv.w1)
    out = (1.0 - beta) * x_hat + beta * (x_hat @ conv.w1)
    return out + (1.0 - beta) * x0 + beta * (x0 @ conv.w2)


def gcn2_no_neighbor(conv: GCN2Conv, cfg: GCN2Config, layer: int,
                     x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """The ``use_aggregation=False`` ablation: skip propagation."""
    return gcn2_update(conv, cfg, layer, x, x0)


class GCN2(ScalableGNN):
    cfg: GCN2Config
    needs_x0 = True

    def __init__(self, cfg: GCN2Config, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator`` (the JAX package's
        initializers); move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        self.x0_dim = c.hidden_channels
        self.convs = nn.ModuleList(
            GCN2Conv(c.hidden_channels, c.shared_weights, generator)
            for _ in range(c.num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(c.hidden_channels)
                                 for _ in range(c.num_layers))
        self.lins = nn.ModuleList([
            Linear(c.in_channels, c.hidden_channels, generator=generator),
            Linear(c.hidden_channels, c.out_channels, generator=generator)])

    def layer_input_dim(self, layer: int) -> int:
        return self.cfg.hidden_channels

    def layer0_cache_input(self, x):
        # M_in[0] = x0 = relu(lin0(x))
        return torch.relu(self.lins[0](x))

    def reg_mask(self) -> Dict[str, bool]:
        """convs and bns are regularized, lins are not (reference
        gcn2.py:61-67)."""
        return {name: not name.startswith("lins.")
                for name, _ in self.named_parameters()}

    def _update(self, layer, x_hat, x0):
        return gcn2_update(self.convs[layer], self.cfg, layer, x_hat, x0)

    def _post(self, layer, h, x_prev, valid, training):
        """bn → residual → relu."""
        c = self.cfg
        if c.batch_norm:
            h = self.bns[layer](h, valid, training)
        if c.residual:
            h = h + x_prev[: h.shape[0]]
        return torch.relu(h)

    # ---------------- GAS forward ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward.  ``x0 = relu(lins[0](x))`` is taken before
        the dropout that follows it.  Returns ``(logits [R_pad, C],
        metrics)``; caches and BatchNorm statistics update in place."""
        c = self.cfg
        r_pad = batch.adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        if c.drop_input:
            x = dropout(x, p, training, generator)
        x = x0 = torch.relu(self.lins[0](x))
        x = dropout(x, p, training, generator)

        if use_aggregation:
            adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(
                batch.batch_size)
            for l in range(c.num_layers - 1):
                h = self._update(l, spmm(adj, x), x0)
                h = self._post(l, h, x, valid, training)
                x = self.push_and_pull(hist_emb, l + 1, h, batch)
                x = dropout(x, p, training, generator)
            h = self._update(c.num_layers - 1, spmm(adj, x), x0)
        else:
            # no-neighbor ablation: in-batch rows only, no cache writes
            x, x0 = x[:r_pad], x0[:r_pad]
            for l in range(c.num_layers - 1):
                h = gcn2_no_neighbor(self.convs[l], c, l, x, x0)
                h = self._post(l, h, x, valid, training)
                x = dropout(h, p, training, generator)
            h = gcn2_no_neighbor(self.convs[-1], c, c.num_layers - 1, x, x0)

        h = self._post(c.num_layers - 1, h, x, valid, training)
        h = self.lins[1](dropout(h, p, training, generator))
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return h, {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    # ---------------- VR forward ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Reverb/VR forward on an in-batch-only batch; the caches are read
        only, and every layer, the last included, ends in ``_post``.
        Returns ``(logits [R_pad, C], metrics)``."""
        c = self.cfg
        adj = batch.adj
        r_pad = adj.num_rows
        c_pad = batch.n_id.shape[0]
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        if c.drop_input:
            x = dropout(x, p, training, generator)
        x = x0 = torch.relu(self.lins[0](x))
        x = dropout(x, p, training, generator)

        drift = torch.zeros((), device=x.device)
        for l in range(c.num_layers):
            x_ib = x[:r_pad]
            m_in, m_ag = self.vr_pull(hist, l, batch, x_ib.shape[1])
            d = x_ib - m_in
            drift = drift + self.drift_term(d, batch, drift_norm)
            x_hat = spmm(adj, pad_rows(d, c_pad)) + m_ag
            h = self._post(l, self._update(l, x_hat, x0[:r_pad]), x_ib, valid, training)
            x = dropout(h, p, training, generator)
        return self.lins[1](x), {"drift": drift / c.num_layers}

    # ---------------- layer-wise eval ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True,
                      pre_agg=None):
        """One layer of the refresh sweep (eval mode, no dropout).  Layer 0
        takes the raw features and computes ``x0`` itself; later layers get
        ``x0_ib`` read back from ``M_in[0]``."""
        c = self.cfg
        if layer == 0:
            x = torch.relu(self.lins[0](x))
            x0_ib = x[: adj.num_rows]
        if use_aggregation:
            agg = pre_agg if pre_agg is not None else spmm(adj, x)
            h = self._update(layer, agg, x0_ib)
        else:
            h = gcn2_no_neighbor(self.convs[layer], c, layer, x[: adj.num_rows], x0_ib)
        if c.batch_norm:
            h = self.bns[layer](h, None, training=False)
        if c.residual and h.shape[-1] == x.shape[-1]:
            h = h + x[: h.shape[0]]
        h = torch.relu(h)
        if layer == c.num_layers - 1:
            h = self.lins[1](h)
        return h
