"""APPNP with GAS and Reverb/VR training (reference: models/appnp.py).

Port of ``incagg_gnn_tpu/models/appnp.py``.  Predict, then propagate: a
2-layer MLP produces ``x_0`` (``out_channels`` wide), then ``num_layers``
personalized-PageRank steps ``x = (1 − α)·(A @ x) + α·x_0``.  The caches
live in output space (``hist_dim = out_channels``), so every propagation
aggregates ``out_channels`` columns.  The VR rule substitutes
``A_ib @ (x − M_in) + M_ag`` for ``A @ x``.  ``M_in[0]`` caches the MLP
output, which the refresh reads back as ``x_0`` for the layers after 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.models.base import BaseConfig, ScalableGNN
from incagg_gnn_tpu_torch.models.nn import Linear, dropout, pad_rows
from incagg_gnn_tpu_torch.ops.agg import edge_counts, spmm


@dataclasses.dataclass(frozen=True)
class APPNPConfig(BaseConfig):
    alpha: float = 0.1


class APPNP(ScalableGNN):
    cfg: APPNPConfig
    needs_x0 = True

    def __init__(self, cfg: APPNPConfig, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator`` (the JAX package's
        initializers); move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        self.x0_dim = c.out_channels
        self.lins = nn.ModuleList([
            Linear(c.in_channels, c.hidden_channels, generator=generator),
            Linear(c.hidden_channels, c.out_channels, generator=generator)])

    @property
    def hist_dim(self) -> int:
        return self.cfg.out_channels  # reference appnp.py:24

    def layer_input_dim(self, layer: int) -> int:
        return self.cfg.out_channels

    def _mlp(self, x, training, generator):
        p = self.cfg.dropout
        x = dropout(x, p, training, generator)
        x = dropout(torch.relu(self.lins[0](x)), p, training, generator)
        return self.lins[1](x)

    def layer0_cache_input(self, x):
        # M_in[0] = the MLP output in eval mode (reference appnp.py:249-251)
        return self._mlp(x, False, None)

    def reg_mask(self) -> Dict[str, bool]:
        """lins[0] is regularized, lins[1] is not (reference appnp.py:36-37)."""
        return {name: name.startswith("lins.0.") for name, _ in self.named_parameters()}

    def _step(self, agg, x0):
        alpha = self.cfg.alpha
        return (1 - alpha) * agg + alpha * x0

    # ---------------- GAS forward (reference appnp.py:44-106) ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward: the MLP, then ``num_layers`` propagations,
        each but the last pushed into ``hist_emb[l+1]`` and spliced with
        the pulled out-of-batch rows.  Returns ``(logits [R_pad, C],
        metrics)``."""
        c = self.cfg
        r_pad = batch.adj.num_rows
        x = self._mlp(x, training, generator)
        if use_aggregation:
            adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(
                batch.batch_size)
            x0 = x[:r_pad]
            # num_layers propagations, emb[l] = the input of propagation l
            # (the JAX package fixes the count: incagg_gnn_tpu/models/appnp.py:91-96)
            for l in range(c.num_layers):
                x_prop = self._step(spmm(adj, x), x0)
                if l == c.num_layers - 1:
                    out = x_prop
                else:
                    x = self.push_and_pull(hist_emb, l + 1, x_prop, batch)
        else:
            x = x0 = x[:r_pad]
            for _ in range(c.num_layers):
                x = self._step(x, x0)
            out = x
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return out, {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    # ---------------- VR forward (reference appnp.py:108-137) ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Reverb/VR forward on an in-batch-only batch: the MLP on the
        in-batch rows, then per propagation ``(1−α)(A_ib @ (x − M_in) +
        M_ag) + α x_0``; the caches are read only."""
        c = self.cfg
        adj = batch.adj
        r_pad = adj.num_rows
        c_pad = batch.n_id.shape[0]
        x = x0 = self._mlp(x[:r_pad], training, generator)
        drift = torch.zeros((), device=x.device)
        for l in range(c.num_layers):
            m_in, m_ag = self.vr_pull(hist, l, batch, x.shape[1])
            d = x - m_in
            drift = drift + self.drift_term(d, batch, drift_norm)
            x = self._step(spmm(adj, pad_rows(d, c_pad)) + m_ag, x0)
        return x, {"drift": drift / c.num_layers}

    # ---------------- layer-wise eval (reference appnp.py:140-166) ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True,
                      pre_agg=None):
        """One propagation of the refresh sweep.  Layer 0 takes the raw
        features and computes ``x_0`` itself; later layers get ``x0_ib``
        read back from ``M_in[0]``.  ``pre_agg`` is ``A @ x`` when the VR
        refresh already computed it."""
        if layer == 0:
            x = self.layer0_cache_input(x)
            x0_ib = x[: adj.num_rows]
        if use_aggregation:
            agg = pre_agg if pre_agg is not None else spmm(adj, x)
            return self._step(agg, x0_ib)
        return self._step(x[: adj.num_rows], x0_ib)
