"""PNA with Jumping Knowledge (reference: models/pna_jk.py).

Port of ``incagg_gnn_tpu/models/pna_jk.py``: PNA layers that all output
``hidden_channels`` and each apply bn + relu; a linear JK head maps the
concatenation of every layer's output to the classes.  GAS pushes each
layer's output (the JK concat of the training forward uses the fresh
in-batch rows); VR is the mock in-batch propagation with the head (there
is no true-VR rule).  The layer-wise refresh assembles the last layer's
logits from the earlier layers' outputs, which ``emb[1..L-1]`` hold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from incagg_gnn_tpu_torch.history import HistoryState, pull, push
from incagg_gnn_tpu_torch.models.base import valid_rows
from incagg_gnn_tpu_torch.models.nn import Linear, dropout, pad_cols
from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig, pna_conv
from incagg_gnn_tpu_torch.ops.agg import edge_counts


@dataclasses.dataclass(frozen=True)
class PNAJKConfig(PNAConfig):
    pass


class PNA_JK(PNA):
    """Every conv outputs ``hidden_channels``; the JK head maps the concat
    of all layer outputs to ``out_channels`` (reference pna_jk.py:30-44)."""

    cfg: PNAJKConfig

    def __init__(self, cfg: PNAJKConfig, generator: Optional[torch.Generator] = None):
        if cfg.true_vr:
            raise NotImplementedError(
                "PNA_JK has no true-VR rule (forward_vr is the mock in-batch "
                "propagation with the JK head); set true_vr on plain PNA")
        super().__init__(cfg, generator)
        self.jk = Linear(cfg.num_layers * cfg.hidden_channels, cfg.out_channels,
                         generator=generator)

    def _out_dim(self, layer: int) -> int:
        return self.cfg.hidden_channels

    def _num_bns(self) -> int:
        return self.cfg.num_layers

    def reg_mask(self) -> Dict[str, bool]:
        """convs and bns are regularized, the JK head is not."""
        return {name: not name.startswith("jk.") for name, _ in self.named_parameters()}

    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        c = self.cfg
        r_pad = batch.adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        if c.drop_input:
            x = dropout(x, c.dropout, training, generator)
        adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(batch.batch_size)
        bin_adj = adj.binarized()
        xs = []
        for l in range(c.num_layers):
            h = self._post(l, pna_conv(self.convs[l], x, bin_adj), x, valid, training)
            xs.append(h[:r_pad])
            if l < c.num_layers - 1:
                x = self.push_and_pull(hist_emb, l + 1, h, batch)
                x = dropout(x, c.dropout, training, generator)
        out = self.jk(torch.cat(xs, dim=-1))
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return out, {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Plain in-batch propagation with the JK head (PNA's mock VR)."""
        c = self.cfg
        bin_adj = batch.adj.binarized()
        r_pad = bin_adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        if c.drop_input:
            x = dropout(x, c.dropout, training, generator)
        xs = []
        for l in range(c.num_layers):
            h = self._post(l, pna_conv(self.convs[l], x, bin_adj), x, valid, training)
            xs.append(h[:r_pad])
            if l < c.num_layers - 1:
                x = dropout(h, c.dropout, training, generator)
        out = self.jk(torch.cat(xs, dim=-1))
        return out, {"drift": torch.zeros((), device=out.device)}

    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True, pre_agg=None):
        """One layer of the refresh sweep: every layer applies bn + relu
        (reference pna_jk.py:101-126)."""
        h = pna_conv(self.convs[layer], x, adj.binarized())
        return self._post(layer, h, x, None, training=False)

    @torch.no_grad()
    def _refresh_batch(self, layer, vr, use_aggregation, hist, x_table, out_table,
                       batch) -> None:
        """The generic refresh for every layer but the last; there, the JK
        logits from the earlier layers' outputs (``emb[1..L-1]`` at the
        batch's rows, cut to ``hidden_channels``) and this layer's output
        (reference pna_jk.py:117-153).  Padded rows write zeros into the
        trash row."""
        last = self.cfg.num_layers - 1
        if layer < last:
            return super()._refresh_batch(layer, vr, use_aggregation, hist, x_table,
                                          out_table, batch)
        adj = batch.adj
        r_pad = adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x_table.device)
        x_in = pull(hist.emb[layer], batch.n_id)[:, :self.layer_input_dim(layer)]
        if vr:
            ag = self.vr_cache_value(layer, adj, x_in)
            push(hist.emb_ag[layer], batch.push_idx,
                 torch.where(valid, pad_cols(ag, self.hist_dim), 0.0))
        hid = self.cfg.hidden_channels
        xs = [pull(hist.emb[j], batch.push_idx)[:, :hid] for j in range(1, last + 1)]
        out = self.forward_layer(layer, x_in, None, adj, use_aggregation)
        logits = self.jk(torch.cat(xs + [out[:r_pad]], dim=-1))
        push(out_table, batch.push_idx, torch.where(valid, logits, 0.0))
