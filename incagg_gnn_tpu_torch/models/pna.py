"""PNA — Principal Neighborhood Aggregation (reference: models/pna.py).

Port of ``incagg_gnn_tpu/models/pna.py``.  One PNAConv is, for each
(aggregator, scaler) branch, a pre-linear + ReLU, the aggregation over the
binarized batch adjacency, a post-linear and a degree scaler, summed over
the branches, plus a root ``lin(x)``:

    out = Σ_{(aggr, scaler)} scaler(deg) · post_lin(aggr(A, relu(pre_lin(x))))
          + lin(x)[:R]

Scalers: identity, amplification ``log(d+1)/avg_log_deg``, attenuation
``avg_log_deg/(log(d+1)+eps)``; the degree statistics come from the full
graph (:func:`compute_avg_deg`).

The branches are stacked (:class:`PNAConv`): the pre-linears of the sum
and mean branches are one GEMM and one launch of kernel B
(``ops/kernels.py::hybrid_spmm``) for all of them, a mean being that sum
over ``max(deg, 1)``; the pre-linears of the max and min branches are one
GEMM and one launch of kernel B's max form (``hybrid_max``) over
``[h_max, -h_min]``, min being ``-max(-h)``; the post-linears are one
``bmm``.  Per column this is the JAX package's branch-by-branch loop: only
the order in which the branches' outputs are summed differs.  The
parameters are held stacked in that order; ``convert.load_pna_params``
stacks the JAX package's per-branch ones.

Reverb/VR: ``true_vr=False`` (default) is the reference's shipped "mock"
VR (plain propagation over the in-batch graph; the caches are read for the
drift only).  ``true_vr=True`` is the exact incremental rule for the sum
and mean branches: the refresh packs one full-neighborhood sum of
``relu(pre_lin_i(x))`` per such branch into ``emb_ag`` (stride
``_d_pack``) and the full degree in the last column; training computes
``Σ_ib(h_i − relu(pre_lin_i(M_in))) + M_ag_i`` (over ``deg_full`` for a
mean), max and min propagate fresh over the in-batch graph, and the
scalers read ``deg_full``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState, pull
from incagg_gnn_tpu_torch.models.base import (
    BaseConfig, ScalableGNN, StreamedPulls, valid_rows)
from incagg_gnn_tpu_torch.models.nn import MaskedBatchNorm, dropout, pad_cols, pad_rows
from incagg_gnn_tpu_torch.ops.agg import edge_counts, spmm, spmm_reduce

EPS = 1e-5
_LINEAR = ("sum", "mean")


@dataclasses.dataclass(frozen=True)
class PNAConfig(BaseConfig):
    aggregators: Sequence[str] = ("mean", "max", "min", "sum")
    scalers: Sequence[str] = ("identity", "amplification", "attenuation")
    avg_deg_lin: float = 1.0  # mean(deg) over the full graph
    avg_deg_log: float = 1.0  # mean(log(deg+1))
    drop_input: bool = True
    batch_norm: bool = False
    residual: bool = False
    #: exact per-branch VR for the sum/mean branches; False = the
    #: reference's "mock" in-batch propagation
    true_vr: bool = False


def compute_avg_deg(degrees: np.ndarray) -> Tuple[float, float]:
    """Degree statistics for the scalers (reference pna.py:35-39)."""
    deg = degrees.astype(np.float64)
    return float(deg.mean()), float(np.log(deg + 1).mean())


def branches(cfg: PNAConfig) -> List[Tuple[str, str]]:
    """(aggregator, scaler) of each branch, in the JAX package's order
    (aggregator outer, scaler inner)."""
    for a in cfg.aggregators:
        if a not in ("sum", "mean", "max", "min"):
            raise ValueError(f"unknown aggregator {a!r}")
    for s in cfg.scalers:
        if s not in ("identity", "amplification", "attenuation"):
            raise ValueError(f"unknown scaler {s!r}")
    return [(a, s) for a in cfg.aggregators for s in cfg.scalers]


class PNAConv(nn.Module):
    """One PNAConv's parameters, stacked over its branches.  ``order[p]``
    is the JAX package's index of the branch at stacked position ``p``:
    the sum and mean branches first (``n_lin`` of them, in the JAX order,
    which is also the order of ``emb_ag``'s packed blocks), then the max
    and min branches.  ``pre_w [in, nb*out]``, ``pre_b [nb*out]``,
    ``post_w [nb, out, out]``, ``post_b [nb, out]``, ``lin_w [in, out]``,
    ``lin_b [out]``; uniform in ±sqrt(1/fan_in), the JAX package's
    ``linear_init``."""

    def __init__(self, cfg: PNAConfig, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        br = branches(cfg)
        lin = [i for i, (a, _) in enumerate(br) if a in _LINEAR]
        self.order = lin + [i for i, (a, _) in enumerate(br) if a not in _LINEAR]
        self.n_lin, nb = len(lin), len(br)
        self.out_dim = out_dim
        self.avg_deg_log = cfg.avg_deg_log

        def uniform(fan_in, *shape):
            lim = math.sqrt(1.0 / fan_in)
            return nn.Parameter(torch.empty(*shape).uniform_(-lim, lim, generator=generator))

        self.pre_w = uniform(in_dim, in_dim, nb * out_dim)
        self.pre_b = uniform(in_dim, nb * out_dim)
        self.post_w = uniform(out_dim, nb, out_dim, out_dim)
        self.post_b = uniform(out_dim, nb, out_dim)
        self.lin_w = uniform(in_dim, in_dim, out_dim)
        self.lin_b = uniform(in_dim, out_dim)
        aggr = [br[i][0] for i in self.order]
        scaler = [br[i][1] for i in self.order]
        # per stacked position: mean divides by the degree, min negates
        # around the max, the scaler's kind
        self.register_buffer("is_mean", torch.tensor([a == "mean" for a in aggr[:self.n_lin]]),
                             persistent=False)
        sign = torch.tensor([-1.0 if a == "min" else 1.0 for a in aggr[self.n_lin:]])
        self.register_buffer("mm_sign", sign.repeat_interleave(out_dim), persistent=False)
        self.register_buffer("amp", torch.tensor([s == "amplification" for s in scaler]),
                             persistent=False)
        self.register_buffer("att", torch.tensor([s == "attenuation" for s in scaler]),
                             persistent=False)

    @property
    def n_mm(self) -> int:
        return len(self.order) - self.n_lin

    def pre(self, x: torch.Tensor, max_min: bool = True):
        """``relu(pre_lin_i(x))`` of the sum/mean branches ``[rows,
        n_lin*out]`` and, with ``max_min``, of the max/min branches with the
        min ones negated ``[rows, n_mm*out]`` (None where a group is
        empty)."""
        x = x.float()
        split = self.n_lin * self.out_dim
        h_lin = h_mm = None
        if self.n_lin:
            h_lin = torch.relu(torch.addmm(self.pre_b[:split], x, self.pre_w[:, :split]))
        if max_min and self.n_mm:
            h_mm = torch.relu(torch.addmm(self.pre_b[split:], x, self.pre_w[:, split:]))
            h_mm = h_mm * self.mm_sign
        return h_lin, h_mm

    def mean(self, agg: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
        """The sum/mean group's sums, the mean branches' divided by
        ``max(deg, 1)``."""
        r = agg.shape[0]
        div = torch.where(self.is_mean, deg.clamp(min=1.0)[:, None], 1.0)
        return (agg.view(r, self.n_lin, self.out_dim) / div[:, :, None]).view(r, -1)

    def max_min(self, bin_adj, h_mm: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The max/min group's aggregation: one max over ``[h_max, -h_min]``,
        the min half negated back."""
        if h_mm is None:
            return None
        return spmm_reduce(bin_adj, h_mm, "max") * self.mm_sign

    def post(self, agg_lin: Optional[torch.Tensor], agg_mm: Optional[torch.Tensor],
             deg: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The post-linears (one ``bmm``), the degree scalers and the sum
        over the branches, plus ``lin(x)`` on the aggregate's rows."""
        agg = torch.cat([a for a in (agg_lin, agg_mm) if a is not None], dim=1)
        r, nb = agg.shape[0], len(self.order)
        y = torch.baddbmm(self.post_b[:, None, :],
                          agg.view(r, nb, self.out_dim).transpose(0, 1), self.post_w)
        logd = torch.log(deg + 1)[None, :, None]
        scale = torch.where(self.amp[:, None, None], logd / self.avg_deg_log,
                            torch.where(self.att[:, None, None],
                                        self.avg_deg_log / (logd + EPS), 1.0))
        return (y * scale).sum(dim=0) + torch.addmm(self.lin_b, x[:r].float(), self.lin_w)


def pna_conv(conv: PNAConv, x: torch.Tensor, bin_adj) -> torch.Tensor:
    """One PNAConv over ``bin_adj``, the batch adjacency binarized by the
    caller (reference pna.py:60-84)."""
    h_lin, h_mm = conv.pre(x)
    deg = bin_adj.deg
    agg_lin = conv.mean(spmm(bin_adj, h_lin), deg) if h_lin is not None else None
    return conv.post(agg_lin, conv.max_min(bin_adj, h_mm), deg, x)


class PNA(ScalableGNN):
    cfg: PNAConfig
    vr_reduce = "mean"

    def __init__(self, cfg: PNAConfig, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator``; move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        self.convs = nn.ModuleList(
            PNAConv(c, self.layer_input_dim(i), self._out_dim(i), generator)
            for i in range(c.num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(c.hidden_channels)
                                 for _ in range(self._num_bns()))

    def _out_dim(self, layer: int) -> int:
        c = self.cfg
        return c.out_channels if layer == c.num_layers - 1 else c.hidden_channels

    def _num_bns(self) -> int:
        return max(self.cfg.num_layers - 1, 1)

    # -------- true-VR packed-cache geometry --------
    @property
    def _d_pack(self) -> int:
        """Per-branch stride in the packed ``emb_ag`` (the widest layer output)."""
        return max(self.cfg.hidden_channels, self.cfg.out_channels)

    @property
    def _n_linear(self) -> int:
        return self.convs[0].n_lin

    @property
    def vr_cache_is_agg(self) -> bool:
        return not self.cfg.true_vr

    @property
    def hist_dim(self) -> int:
        # layer 0 caches the raw features
        base = max(self.cfg.in_channels, self.cfg.hidden_channels)
        if not self.cfg.true_vr:
            return base
        # packed per-branch aggregates + the full-degree column
        return max(base, self._n_linear * self._d_pack + 1)

    def layer_input_dim(self, layer: int) -> int:
        return self.cfg.in_channels if layer == 0 else self.cfg.hidden_channels

    def reg_mask(self) -> Dict[str, bool]:
        """convs[:-1] and bns are regularized, the last conv is not
        (reference pna.py:125-131)."""
        last = self.cfg.num_layers - 1
        return {name: not name.startswith(f"convs.{last}.")
                for name, _ in self.named_parameters()}

    def _post(self, layer, h, x_prev, valid, training):
        """bn → residual → relu."""
        c = self.cfg
        if c.batch_norm:
            h = self.bns[layer](h, valid, training)
        if c.residual and h.shape[-1] == x_prev.shape[-1]:
            h = h + x_prev[: h.shape[0]]
        return torch.relu(h)

    # ---------------- GAS forward (reference pna.py:138-158) ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward; ``aggregate_combined=False`` aggregates
        over the in-batch edges only.  Returns ``(logits [R_pad, C],
        metrics)``; caches and BatchNorm statistics update in place."""
        c = self.cfg
        valid = valid_rows(batch.adj.num_rows, batch.batch_size, x.device)[:, 0]
        if c.drop_input:
            x = dropout(x, c.dropout, training, generator)
        adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(batch.batch_size)
        bin_adj = adj.binarized()
        for l in range(c.num_layers - 1):
            h = self._post(l, pna_conv(self.convs[l], x, bin_adj), x, valid, training)
            x = self.push_and_pull(hist_emb, l + 1, h, batch)
            x = dropout(x, c.dropout, training, generator)
        out = pna_conv(self.convs[-1], x, bin_adj)
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return out, {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    # ---------------- VR refresh cache (true_vr) ----------------
    def vr_cache_value(self, layer: int, adj, x: torch.Tensor) -> torch.Tensor:
        """With ``true_vr``: one full-neighborhood sum of ``relu(pre_lin_i(x))``
        per sum/mean branch, each padded to ``_d_pack`` columns, then the
        full-degree column."""
        if not self.cfg.true_vr:
            return super().vr_cache_value(layer, adj, x)
        bin_adj = adj.binarized()
        conv = self.convs[layer]
        h_lin, _ = conv.pre(x, max_min=False)
        agg = spmm(bin_adj, h_lin)
        r = agg.shape[0]
        packed = pad_cols(agg.view(r * conv.n_lin, conv.out_dim), self._d_pack)
        return torch.cat([packed.view(r, -1), bin_adj.deg[:, None]], dim=1)

    def _vr_pull_full(self, hist, layer: int, batch, in_dim: int):
        """The in-batch rows of the layer-input cache, cropped to the layer
        width, and the full-width packed ``emb_ag`` rows, in f32: gathered
        from the device caches, or the spill tier's staged
        :class:`StreamedPulls`."""
        if isinstance(hist, StreamedPulls):
            return hist.m_in[layer][:, :in_dim], hist.m_ag[layer]
        return (pull(hist.emb[layer], batch.push_idx)[:, :in_dim],
                pull(hist.emb_ag[layer], batch.push_idx))

    # ---------------- VR forward ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        if self.cfg.true_vr:
            return self._forward_vr_true(x, batch, hist, generator, training, drift_norm)
        return self._forward_vr_mock(x, batch, hist, generator, training, drift_norm)

    def _forward_vr_true(self, x, batch, hist, generator, training, drift_norm: int = 2):
        """Exact incremental aggregation for the sum/mean branches; fresh
        in-batch propagation for max/min (no incremental form exists)."""
        c = self.cfg
        bin_adj = batch.adj.binarized()
        r_pad = bin_adj.num_rows
        c_pad = batch.n_id.shape[0]
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        deg_col = self._n_linear * self._d_pack
        if c.drop_input:
            x = dropout(x, c.dropout, training, generator)
        drift = torch.zeros((), device=x.device)
        for l in range(c.num_layers):
            in_dim = self.layer_input_dim(l)
            conv = self.convs[l]
            m_in, packed = self._vr_pull_full(hist, l, batch, in_dim)
            drift = drift + self.drift_term(x[:r_pad, :in_dim] - m_in, batch, drift_norm)
            deg_full = packed[:, deg_col]
            h_lin, h_mm = conv.pre(x)
            agg_lin = None
            if h_lin is not None:
                m_lin, _ = conv.pre(m_in, max_min=False)
                agg = spmm(bin_adj, pad_rows(h_lin[:r_pad] - m_lin, c_pad))
                cached = packed[:, :deg_col].reshape(r_pad, conv.n_lin, self._d_pack)
                cached = cached[:, :, :conv.out_dim].reshape(r_pad, -1)
                agg_lin = conv.mean(agg + cached, deg_full)
            h = conv.post(agg_lin, conv.max_min(bin_adj, h_mm), deg_full, x)
            if l < c.num_layers - 1:
                h = self._post(l, h, x, valid, training)
                x = dropout(h, c.dropout, training, generator)
        return h, {"drift": drift / c.num_layers}

    def _forward_vr_mock(self, x, batch, hist, generator, training, drift_norm: int = 2):
        """Plain propagation over the in-batch batch graph (the reference's
        shipped PNA VR, pna.py:235,270); the caches give the drift only."""
        c = self.cfg
        bin_adj = batch.adj.binarized()
        r_pad = bin_adj.num_rows
        valid = valid_rows(r_pad, batch.batch_size, x.device)[:, 0]
        if c.drop_input:
            x = dropout(x, c.dropout, training, generator)
        drift = torch.zeros((), device=x.device)
        for l in range(c.num_layers - 1):
            m_in, _ = self.vr_pull(hist, l, batch, min(x.shape[1], self.hist_dim))
            drift = drift + self.drift_term(x[:r_pad, :m_in.shape[1]] - m_in, batch,
                                            drift_norm)
            h = self._post(l, pna_conv(self.convs[l], x, bin_adj), x, valid, training)
            x = dropout(h, c.dropout, training, generator)
        out = pna_conv(self.convs[-1], x, bin_adj)
        return out, {"drift": drift / max(c.num_layers - 1, 1)}

    # ---------------- layer-wise eval (reference pna.py:282-295) ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True, pre_agg=None):
        """One layer of the refresh sweep (eval mode); the branches cannot
        reuse a cached sum, so ``pre_agg`` is ignored."""
        h = pna_conv(self.convs[layer], x, adj.binarized())
        if layer < self.cfg.num_layers - 1:
            h = self._post(layer, h, x, None, training=False)
        return h
