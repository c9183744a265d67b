"""GCN with GAS and Reverb/VR training (reference: models/gcn.py).

Port of ``incagg_gnn_tpu/models/gcn.py``.  Layer math (PyG
``GCNConv(normalize=False)``): ``h = A @ (x W) + b`` with the gcn-normalized
adjacency from the pipeline.  The VR forward aggregates first: ``h = (A_ib @
(x - M_in) + M_ag) W + b`` (reference gcn.py:241-244).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState, push
from incagg_gnn_tpu_torch.models.base import BaseConfig, ScalableGNN, valid_rows
from incagg_gnn_tpu_torch.models.nn import (
    Linear, MaskedBatchNorm, dropout, pad_cols, pad_rows)
from incagg_gnn_tpu_torch.ops.agg import edge_counts, spmm


@dataclasses.dataclass(frozen=True)
class GCNConfig(BaseConfig):
    drop_input: bool = True
    batch_norm: bool = False
    residual: bool = False
    linear: bool = False


def gcn_conv(conv: Linear, x: torch.Tensor, adj) -> torch.Tensor:
    """``A @ (x W) + b`` (transform, then aggregate)."""
    return spmm(adj, x.float() @ conv.w) + conv.b


def gcn_conv_vr(conv: Linear, adj, x_ib, m_in, m_ag, c_pad: int) -> torch.Tensor:
    """VR rule, then transform: ``((A_ib @ (x − M_in)) + M_ag) W + b``."""
    h = spmm(adj, pad_rows(x_ib - m_in, c_pad)) + m_ag
    return h @ conv.w + conv.b


class GCN(ScalableGNN):
    cfg: GCNConfig

    def __init__(self, cfg: GCNConfig, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator`` (the JAX package's
        initializers: glorot-uniform conv weights); move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        convs = []
        for i in range(c.num_layers):
            in_dim = out_dim = c.hidden_channels
            if i == 0 and not c.linear:
                in_dim = c.in_channels
            if i == c.num_layers - 1 and not c.linear:
                out_dim = c.out_channels
            convs.append(Linear(in_dim, out_dim, init="glorot", generator=generator))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(MaskedBatchNorm(c.hidden_channels)
                                 for _ in range(c.num_layers))
        if c.linear:
            self.lins = nn.ModuleList([
                Linear(c.in_channels, c.hidden_channels, generator=generator),
                Linear(c.hidden_channels, c.out_channels, generator=generator)])

    @property
    def hist_dim(self) -> int:
        # layer-0 caches raw features, so the width covers in_channels
        if self.cfg.linear:
            return self.cfg.hidden_channels
        return max(self.cfg.in_channels, self.cfg.hidden_channels)

    def layer_input_dim(self, layer: int) -> int:
        if layer == 0 and not self.cfg.linear:
            return self.cfg.in_channels
        return self.cfg.hidden_channels

    def layer0_cache_input(self, x):
        if self.cfg.linear:
            return torch.relu(self.lins[0](x))
        return x

    def reg_mask(self) -> Dict[str, bool]:
        """Parameter name -> True for ``reg_weight_decay``, False for
        ``nonreg_weight_decay`` (reference gcn.py:77-86: convs[:-1] + bns are
        regularized, the last conv is not; convs+bns and not lins when
        ``linear``)."""
        c = self.cfg
        mask = {}
        for name, _ in self.named_parameters():
            if name.startswith("convs."):
                mask[name] = int(name.split(".")[1]) < c.num_layers - 1 or c.linear
            else:
                mask[name] = name.startswith("bns.")
        return mask

    # ---------------- helpers ----------------
    def _post_conv(self, layer, h, x_prev, valid, training):
        """bn → residual → relu (reference gcn.py:144-148)."""
        c = self.cfg
        if c.batch_norm:
            h = self.bns[layer](h, valid, training)
        if c.residual and h.shape[-1] == x_prev.shape[-1]:
            h = h + x_prev[: h.shape[0]]
        return torch.relu(h)

    def _edge_counts(self, batch) -> Dict:
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    # ---------------- GAS forward ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward: per layer, compute, push the in-batch rows
        into ``hist_emb[l+1]`` and pull the out-of-batch rows.  Returns
        ``(logits [R_pad, C], metrics)``; caches and BatchNorm statistics
        update in place."""
        c = self.cfg
        r_pad = batch.adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        if c.drop_input:
            x = dropout(x, p, training, generator)
        if c.linear:
            x = dropout(torch.relu(self.lins[0](x)), p, training, generator)

        if use_aggregation:
            adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(
                batch.batch_size)
            for l in range(c.num_layers - 1):
                h = gcn_conv(self.convs[l], x, adj)
                h = self._post_conv(l, h, x, valid, training)
                x = self.push_and_pull(hist_emb, l + 1, h, batch)
                x = dropout(x, p, training, generator)
            h = gcn_conv(self.convs[-1], x, adj)
        else:
            # MLP degrade: in-batch rows only (reference gcn.py:167-193)
            x = x[:r_pad]
            for l in range(c.num_layers - 1):
                h = self._post_conv(l, self.convs[l](x), x, valid, training)
                push(hist_emb[l + 1], batch.push_idx, pad_cols(h, self.hist_dim))
                x = dropout(h, p, training, generator)
            h = self.convs[-1](x)

        if c.linear:
            h = self._post_conv(c.num_layers - 1, h, x, valid, training)
            h = self.lins[1](dropout(h, p, training, generator))
        return h, self._edge_counts(batch)

    # ---------------- VR forward ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Reverb/VR forward on an in-batch-only batch; the caches are read
        only.  Returns ``(logits [R_pad, C], metrics)``."""
        c = self.cfg
        adj = batch.adj
        r_pad = adj.num_rows
        c_pad = batch.n_id.shape[0]
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        if c.drop_input:
            x = dropout(x, p, training, generator)
        if c.linear:
            x = dropout(torch.relu(self.lins[0](x)), p, training, generator)

        drift = torch.zeros((), device=x.device)
        for l in range(c.num_layers):
            x_ib = x[:r_pad]
            m_in, m_ag = self.vr_pull(hist, l, batch, x_ib.shape[1])
            drift = drift + self.drift_term(x_ib - m_in, batch, drift_norm)
            h = gcn_conv_vr(self.convs[l], adj, x_ib, m_in, m_ag, c_pad)
            if l < c.num_layers - 1 or c.linear:
                h = self._post_conv(l, h, x_ib, valid, training)
                if l < c.num_layers - 1:
                    x = dropout(h, p, training, generator)
        if c.linear:
            h = self.lins[1](dropout(h, p, training, generator))
        return h, {"drift": drift / c.num_layers, **self._edge_counts(batch)}

    # ---------------- layer-wise eval ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True,
                      pre_agg=None):
        """One layer of the refresh sweep (eval mode, no dropout).
        ``pre_agg`` is this layer's aggregation of ``x`` when the VR refresh
        already computed it: ``A@(xW) == (A@x)W``."""
        c = self.cfg
        if layer == 0 and c.linear:
            x = torch.relu(self.lins[0](x))
        if use_aggregation:
            if pre_agg is not None:
                h = self.convs[layer](pre_agg)
            else:
                h = gcn_conv(self.convs[layer], x, adj)
        else:
            h = self.convs[layer](x[: adj.num_rows])
        if layer < c.num_layers - 1 or c.linear:
            if c.batch_norm:
                h = self.bns[layer](h, None, training=False)
            if c.residual and h.shape[-1] == x.shape[-1]:
                h = h + x[: h.shape[0]]
            h = torch.relu(h)
        if c.linear and layer == c.num_layers - 1:
            h = self.lins[1](h)
        return h
