"""GraphSAGE with GAS and Reverb/VR training (reference: models/graphsage.py).

Port of ``incagg_gnn_tpu/models/graphsage.py``.  Layer math (PyG
``SAGEConv(normalize=False)``, mean aggregator)::

    h = lin_l(mean_{j∈N(i)} x_j) + lin_r(x_i)

The mean runs over the *binarized* adjacency (``adj_t.set_value(None)``,
reference graphsage.py:628), whatever values the pipeline's gcn_norm left
on it, and divides by the true degree.  The VR forward substitutes the
incremental rule ``mean(A_ib, x − M_in) + M_ag`` for the mean, and ``M_ag``
caches the binary-mean aggregate (graphsage.py:896-898).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.models.base import BaseConfig, ScalableGNN, valid_rows
from incagg_gnn_tpu_torch.models.nn import Linear, MaskedBatchNorm, dropout, pad_rows
from incagg_gnn_tpu_torch.ops.agg import edge_counts, spmm_mean


@dataclasses.dataclass(frozen=True)
class SAGEConfig(BaseConfig):
    drop_input: bool = True
    batch_norm: bool = False
    residual: bool = False
    linear: bool = False


class SAGEConv(nn.Module):
    """The two linears of one SAGEConv: ``lin_l`` (with bias) on the
    aggregate, ``lin_r`` (no bias) on the root rows."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = Linear(in_dim, out_dim, generator=generator)
        self.lin_r = Linear(in_dim, out_dim, bias=False, generator=generator)

    def root(self, agg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``lin_l(agg) + lin_r(x_root)`` over the aggregate's rows."""
        return self.lin_l(agg) + self.lin_r(x[: agg.shape[0]])


def sage_conv(conv: SAGEConv, x: torch.Tensor, bin_adj) -> torch.Tensor:
    """``lin_l(mean(A) x) + lin_r(x_root)`` over ``bin_adj``, the batch
    adjacency binarized once by the caller (``adj.binarized()``)."""
    return conv.root(spmm_mean(bin_adj, x), x)


class GraphSAGE(ScalableGNN):
    cfg: SAGEConfig
    vr_reduce = "mean"

    def __init__(self, cfg: SAGEConfig, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator`` (the JAX package's
        initializers: uniform ±sqrt(1/in)); move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        convs = []
        for i in range(c.num_layers):
            in_dim = out_dim = c.hidden_channels
            if i == 0 and not c.linear:
                in_dim = c.in_channels
            if i == c.num_layers - 1 and not c.linear:
                out_dim = c.out_channels
            convs.append(SAGEConv(in_dim, out_dim, generator))
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
        return x  # raw features (reference graphsage.py:879)

    def reg_mask(self) -> Dict[str, bool]:
        """convs[:-1] and bns are regularized, the last conv and lins are
        not; every conv when ``linear``."""
        c = self.cfg
        mask = {}
        for name, _ in self.named_parameters():
            if name.startswith("convs."):
                mask[name] = int(name.split(".")[1]) < c.num_layers - 1 or c.linear
            else:
                mask[name] = name.startswith("bns.")
        return mask

    def _post(self, layer, h, x_prev, valid, training):
        """bn → residual → relu."""
        c = self.cfg
        if c.batch_norm:
            h = self.bns[layer](h, valid, training)
        if c.residual and h.shape[-1] == x_prev.shape[-1]:
            h = h + x_prev[: h.shape[0]]
        return torch.relu(h)

    def _edge_counts(self, batch) -> Dict:
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    def _head(self, x, p, training, generator):
        """Input dropout and, when ``linear``, the first linear."""
        if self.cfg.drop_input:
            x = dropout(x, p, training, generator)
        if self.cfg.linear:
            x = dropout(torch.relu(self.lins[0](x)), p, training, generator)
        return x

    def _tail(self, h, x, valid, training, generator):
        """When ``linear``: the last post-conv block and the second linear."""
        c = self.cfg
        if c.linear:
            h = self._post(c.num_layers - 1, h, x, valid, training)
            h = self.lins[1](dropout(h, c.dropout, training, generator))
        return h

    # ---------------- GAS forward (reference graphsage.py:110-366) ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward; ``aggregate_combined=False`` aggregates
        over the in-batch edges only.  Returns ``(logits [R_pad, C],
        metrics)``; caches and BatchNorm statistics update in place."""
        c = self.cfg
        r_pad = batch.adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        x = self._head(x, p, training, generator)

        if use_aggregation:
            adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(
                batch.batch_size)
            bin_adj = adj.binarized()
            for l in range(c.num_layers - 1):
                h = self._post(l, sage_conv(self.convs[l], x, bin_adj), x, valid,
                               training)
                x = self.push_and_pull(hist_emb, l + 1, h, batch)
                x = dropout(x, p, training, generator)
            h = sage_conv(self.convs[-1], x, bin_adj)
        else:
            # MLP degrade: lin_l + lin_r on the root rows only, no cache writes
            x = x[:r_pad]
            for l in range(c.num_layers - 1):
                h = self._post(l, self.convs[l].root(x, x), x, valid, training)
                x = dropout(h, p, training, generator)
            h = self.convs[-1].root(x, x)
        return self._tail(h, x, valid, training, generator), self._edge_counts(batch)

    # ---------------- VR forward (reference graphsage.py:539-707) ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Reverb/VR forward on an in-batch-only batch: per layer
        ``lin_l(mean(A_ib, x − M_in) + M_ag) + lin_r(x)`` over the binarized
        adjacency; the caches are read only."""
        c = self.cfg
        adj = batch.adj
        r_pad = adj.num_rows
        c_pad = batch.n_id.shape[0]
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        p = c.dropout
        x = self._head(x, p, training, generator)

        drift = torch.zeros((), device=x.device)
        bin_adj = adj.binarized()
        for l in range(c.num_layers):
            x_ib = x[:r_pad]
            m_in, m_ag = self.vr_pull(hist, l, batch, x_ib.shape[1])
            d = x_ib - m_in
            drift = drift + self.drift_term(d, batch, drift_norm)
            h = self.convs[l].root(spmm_mean(bin_adj, pad_rows(d, c_pad)) + m_ag, x_ib)
            if l < c.num_layers - 1:
                h = self._post(l, h, x_ib, valid, training)
                x = dropout(h, p, training, generator)
        out = self._tail(h, x, valid, training, generator)
        return out, {"drift": drift / c.num_layers, **self._edge_counts(batch)}

    # ---------------- layer-wise eval (reference graphsage.py:713-765) ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True,
                      pre_agg=None):
        """One layer of the refresh sweep (eval mode, no dropout).
        ``pre_agg`` is the binary-mean aggregation of ``x`` when the VR
        refresh already computed it for ``M_ag``."""
        c = self.cfg
        if layer == 0 and c.linear:
            x = torch.relu(self.lins[0](x))
        conv = self.convs[layer]
        if use_aggregation:
            if pre_agg is not None:
                h = conv.root(pre_agg, x)
            else:
                h = sage_conv(conv, x, adj.binarized())
        else:
            h = conv.root(x[: adj.num_rows], x)
        if layer < c.num_layers - 1 or c.linear:
            if c.batch_norm:
                h = self.bns[layer](h, None, training=False)
            if c.residual and h.shape[-1] == x.shape[-1]:
                h = h + x[: h.shape[0]]
            h = torch.relu(h)
        if c.linear and layer == c.num_layers - 1:
            h = self.lins[1](h)
        return h
