"""GAT with historical embeddings (reference: models/gat.py).

Port of ``incagg_gnn_tpu/models/gat.py``.  A bipartite multi-head
attention conv (PyG ``GATConv(add_self_loops=False)`` applied as
``conv((x, x[:R]), adj_t)``):

    e_ij = LeakyReLU(a_l · (W x_j) + a_r · (W x_i))      per head
    α_ij = softmax_j(e_ij)   (per destination row)
    h_i  = Σ_j α_ij (W x_j)                              concat/mean heads

On the hybrid formats the softmax runs over each row's ELL slots and COO
overflow, and the message sum ``Σ_j α_ij (W x_j)`` is kernel B's heads form
(``ops/kernels.py::hybrid_spmm_heads``): one launch for all heads, the tail
fused.  Training over the hybrid pair uses a scatter-free backward
(:class:`_AttBlock`): the per-edge values computed in the forward layout
(attention coefficients, score gradients) move onto the transpose through
the static slot permutation ``BiHybridAdj.t2f``, so ``d_wx`` is kernel B
over the transposed table and ``d_a_src`` a row sum there.  GAS pushes the
layer outputs and pulls the out-of-batch rows; attention has no linear VR
decomposition, so ``forward_vr`` propagates over the in-batch graph with
zero drift, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.models.base import BaseConfig, ScalableGNN
from incagg_gnn_tpu_torch.models.nn import dropout
from incagg_gnn_tpu_torch.ops.agg import edge_counts
from incagg_gnn_tpu_torch.ops.ell import BiHybridAdj, HybridAdj
from incagg_gnn_tpu_torch.ops.kernels import hybrid_spmm_heads
from incagg_gnn_tpu_torch.ops.spmm import PaddedAdj, segment_softmax

_NEG = -1e30
#: bytes one plain-torch gather of the attention backward may materialize
#: before it is taken in row chunks (the ``[rows, K, H, D]`` products)
_GATHER_BUDGET_BYTES = 512 << 20


@dataclasses.dataclass(frozen=True)
class GATConfig(BaseConfig):
    hidden_heads: int = 4
    out_heads: int = 1


class GATConv(nn.Module):
    """One attention conv's parameters: ``w [in, H*D]``, ``a_l``/``a_r``
    ``[H, D]`` (glorot uniform, the JAX package's initializer) and ``b
    [H*D]`` (zeros)."""

    def __init__(self, in_dim: int, out_dim: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def glorot(*shape):
            lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
            return nn.Parameter(torch.empty(shape).uniform_(-lim, lim, generator=generator))

        self.heads, self.out_dim = heads, out_dim
        self.w = glorot(in_dim, heads * out_dim)
        self.a_l = glorot(heads, out_dim)
        self.a_r = glorot(heads, out_dim)
        self.b = nn.Parameter(torch.zeros(heads * out_dim))

    def project(self, x: torch.Tensor, r_pad: int):
        """``wx [C, H, D]`` and the source / destination scores ``a_src [C,
        H]``, ``a_dst [R_pad, H]``."""
        wx = (x.float() @ self.w).reshape(x.shape[0], self.heads, self.out_dim)
        return wx, (wx * self.a_l).sum(-1), (wx[:r_pad] * self.a_r).sum(-1)

    def finish(self, out: torch.Tensor, concat: bool) -> torch.Tensor:
        """``[R, H, D]`` -> heads concatenated (or averaged), plus the bias."""
        if concat:
            return out.reshape(out.shape[0], -1) + self.b
        return out.mean(dim=1) + self.b.reshape(self.heads, self.out_dim).mean(0)


# ---------------------------------------------------------------------------
# attention over the hybrid ELL + COO layout
# ---------------------------------------------------------------------------

def hybrid_att_coeffs(fwd: HybridAdj, a_src: torch.Tensor, a_dst: torch.Tensor):
    """Masked leaky-relu scores and their row softmax over a row's ELL
    slots and COO overflow.  Returns ``(att_e [R,K,H], att_o [O,H], pre_e,
    pre_o, valid_e, valid_o)``; the pre-activations give the backward its
    leaky-relu factor.  A row with no real edge has its max reset to 0 and
    its sum clamped to 1e-16, so its coefficients are 0."""
    assert not fwd.ext, (
        "GAT attention reads only the ELL core + overflow; extension levels "
        "would be dropped (the loader's k=b.k builds have none)")
    r_pad = fwd.num_rows
    valid_e = (fwd.ell_vals != 0)[..., None]
    pre_e = a_src.index_select(0, fwd.ell_cols.reshape(-1)).reshape(
        *fwd.ell_cols.shape, -1) + a_dst[:, None, :]
    sc_e = torch.where(valid_e, torch.nn.functional.leaky_relu(pre_e, 0.2), _NEG)
    valid_o = (fwd.ovf_vals != 0)[:, None]
    pre_o = a_src.index_select(0, fwd.ovf_cols) + a_dst.index_select(0, fwd.ovf_rows)
    sc_o = torch.where(valid_o, torch.nn.functional.leaky_relu(pre_o, 0.2), _NEG)
    rows = fwd.ovf_rows.long()

    m = sc_e.max(dim=1).values
    if rows.numel():
        m = m.scatter_reduce(0, rows[:, None].expand_as(sc_o), sc_o, "amax")
    m = torch.where(m > _NEG / 2, m, 0.0)
    e_e = torch.where(valid_e, torch.exp(sc_e - m[:, None, :]), 0.0)
    z = e_e.sum(dim=1)
    e_o = torch.where(valid_o, torch.exp(sc_o - m.index_select(0, rows)), 0.0)
    z = z.index_add(0, rows, e_o).clamp(min=1e-16)
    return (e_e / z[:, None, :], e_o / z.index_select(0, rows),
            pre_e, pre_o, valid_e, valid_o)


def att_message_sum(fwd: HybridAdj, att_e: torch.Tensor, att_o: torch.Tensor,
                    wx: torch.Tensor) -> torch.Tensor:
    """``out[r] = Σ_slots att · wx[col]`` per head, ``[R, H, D]``: kernel B's
    heads form, the overflow tail fused through ``ovf_ptr``."""
    c, h, d = wx.shape
    out = hybrid_spmm_heads(fwd.ell_cols, att_e.contiguous(), fwd.ovf_ptr, fwd.ovf_cols,
                            att_o.contiguous(), wx.reshape(c, h * d))
    return out.reshape(fwd.num_rows, h, d)


def _row_chunked(fn, r: int, bytes_per_row: int, *arrs) -> torch.Tensor:
    """``fn`` over the leading (row) axis of ``arrs``, in one call when ``r
    * bytes_per_row`` fits the gather budget, else in row chunks."""
    rc = max(1, _GATHER_BUDGET_BYTES // max(bytes_per_row, 1))
    if rc >= r:
        return fn(*arrs)
    return torch.cat([fn(*(a[i:i + rc] for a in arrs)) for i in range(0, r, rc)])


def _to_bwd_layout(bwd: HybridAdj, t2f: torch.Tensor, flat: torch.Tensor):
    """Per-edge values in the forward flat layout ``[F, H]`` onto the
    transpose through ``t2f`` (padding -> 0): the transposed ELL block
    ``[C, K_t, H]`` and overflow block ``[O_t, H]``."""
    v = torch.where((t2f >= 0)[:, None], flat.index_select(0, t2f.clamp(min=0)), 0.0)
    n_ell = bwd.ell_cols.numel()
    return v[:n_ell].reshape(*bwd.ell_cols.shape, -1), v[n_ell:]


class _AttBlock(torch.autograd.Function):
    """``out[r] = Σ_j softmax_j(sc)·drop·wx[j]`` over a hybrid pair, with the
    scatter-free backward of the JAX package's custom VJP: the softmax is
    recomputed, ``d_a_dst`` is a row sum, and ``d_a_src`` and ``d_wx`` ride
    the transpose through ``t2f`` (``d_wx`` is kernel B's heads form there).
    ``drop_e``/``drop_o``: attention-dropout masks already divided by the
    keep probability, or None for none."""

    @staticmethod
    def forward(ctx, a_src, a_dst, wx, adj: BiHybridAdj, drop_e, drop_o):
        att_e, att_o, *_ = hybrid_att_coeffs(adj.fwd, a_src, a_dst)
        if drop_e is not None:
            att_e, att_o = att_e * drop_e, att_o * drop_o
        ctx.adj = adj
        ctx.save_for_backward(a_src, a_dst, wx, drop_e, drop_o)
        return att_message_sum(adj.fwd, att_e, att_o, wx)

    @staticmethod
    def backward(ctx, g):
        a_src, a_dst, wx, drop_e, drop_o = ctx.saved_tensors
        adj = ctx.adj
        fwd, bwd, t2f = adj.fwd, adj.bwd, adj.t2f
        r_pad, (k, heads, d) = fwd.num_rows, (fwd.ell_cols.shape[1], *wx.shape[1:])
        g = g.contiguous()
        att_e, att_o, pre_e, pre_o, valid_e, valid_o = hybrid_att_coeffs(fwd, a_src, a_dst)
        orows = fwd.ovf_rows.long()

        def attd_part(cols, g_rows):  # [rc, K, H]: g[r] · wx[col], per head
            gw = wx.index_select(0, cols.reshape(-1)).reshape(*cols.shape, heads, d)
            return (gw * g_rows[:, None]).sum(-1)

        d_att_e = _row_chunked(attd_part, r_pad, k * heads * d * 4, fwd.ell_cols, g)
        d_att_o = (wx.index_select(0, fwd.ovf_cols) * g.index_select(0, orows)).sum(-1)
        if drop_e is not None:
            d_att_e, d_att_o = d_att_e * drop_e, d_att_o * drop_o
        # softmax backward per row: d_sc = att * (d_att - Σ_row att·d_att)
        sdot = (att_e * d_att_e).sum(dim=1).index_add(0, orows, att_o * d_att_o)
        d_sc_e = att_e * (d_att_e - sdot[:, None, :])
        d_sc_o = att_o * (d_att_o - sdot.index_select(0, orows))
        # leaky-relu factor, masked to real edges
        d_pre_e = torch.where(valid_e, d_sc_e * torch.where(pre_e >= 0, 1.0, 0.2), 0.0)
        d_pre_o = torch.where(valid_o, d_sc_o * torch.where(pre_o >= 0, 1.0, 0.2), 0.0)
        d_a_dst = d_pre_e.sum(dim=1).index_add(0, orows, d_pre_o)
        # d_a_src: a row sum on the transpose side
        dpb_e, dpb_o = _to_bwd_layout(
            bwd, t2f, torch.cat([d_pre_e.reshape(-1, heads), d_pre_o]))
        d_a_src = dpb_e.sum(dim=1).index_add(0, bwd.ovf_rows.long(), dpb_o)
        # d_wx: the transposed aggregation of att·drop against g
        if drop_e is not None:
            att_e, att_o = att_e * drop_e, att_o * drop_o
        ab_e, ab_o = _to_bwd_layout(bwd, t2f, torch.cat([att_e.reshape(-1, heads), att_o]))
        d_wx = hybrid_spmm_heads(bwd.ell_cols, ab_e.contiguous(), bwd.ovf_ptr, bwd.ovf_cols,
                                 ab_o.contiguous(), g.reshape(r_pad, heads * d))
        return d_a_src, d_a_dst, d_wx.reshape(bwd.num_rows, heads, d), None, None, None


AttDrop = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _draw(shape, p: float, generator, device) -> torch.Tensor:
    """An attention-dropout mask divided by the keep probability."""
    keep = torch.rand(shape, generator=generator, device=device) >= p
    return keep.float() / (1.0 - p)


def gat_conv_bi(conv: GATConv, x: torch.Tensor, adj: BiHybridAdj, concat: bool,
                generator: Optional[torch.Generator], att_dropout: float,
                training: bool, drop: AttDrop = None) -> torch.Tensor:
    """Trainable scatter-free attention over the hybrid pair.  ``drop``
    (``(drop_e [R,K,H], drop_o [O,H])``, divided by the keep probability)
    replaces the masks drawn from ``generator``."""
    assert adj.t2f is not None, (
        "GAT training over hybrid needs the transpose permutation "
        "(loader adj_perm=True)")
    r_pad = adj.fwd.num_rows
    wx, a_src, a_dst = conv.project(x, r_pad)
    if drop is None and training and att_dropout > 0.0 and generator is not None:
        k, o = adj.fwd.ell_cols.shape[1], adj.fwd.ovf_rows.shape[0]
        drop = (_draw((r_pad, k, conv.heads), att_dropout, generator, x.device),
                _draw((o, conv.heads), att_dropout, generator, x.device))
    drop_e, drop_o = drop if drop is not None else (None, None)
    out = _AttBlock.apply(a_src, a_dst, wx, adj, drop_e, drop_o)
    return conv.finish(out, concat)


def gat_conv_hybrid(conv: GATConv, x: torch.Tensor, adj: HybridAdj,
                    concat: bool) -> torch.Tensor:
    """Attention over the forward-only hybrid (refresh and eval sweeps,
    no gradient)."""
    wx, a_src, a_dst = conv.project(x, adj.num_rows)
    att_e, att_o, *_ = hybrid_att_coeffs(adj, a_src, a_dst)
    return conv.finish(att_message_sum(adj, att_e, att_o, wx), concat)


def gat_conv_coo(conv: GATConv, x: torch.Tensor, adj: PaddedAdj, concat: bool,
                 generator: Optional[torch.Generator], att_dropout: float,
                 training: bool, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge-softmax attention over the padded edge list (plain torch, as
    the JAX package leaves COO to XLA).  ``keep`` (bool ``[E_pad, H]``)
    replaces the attention-dropout mask drawn from ``generator``."""
    r_pad = adj.num_rows
    wx, a_src, a_dst = conv.project(x, r_pad)
    scores = torch.nn.functional.leaky_relu(
        a_src.index_select(0, adj.cols) + a_dst.index_select(0, adj.rows), 0.2)
    rows = adj.rows.long()
    att = segment_softmax(scores, rows, r_pad, adj.vals != 0)  # [E_pad, H]
    if training and att_dropout > 0.0 and (generator is not None or keep is not None):
        if keep is None:
            keep = torch.rand(att.shape, generator=generator, device=x.device) >= att_dropout
        att = torch.where(keep, att / (1.0 - att_dropout), 0.0)
    msg = wx.index_select(0, adj.cols) * att[:, :, None]
    out = msg.new_zeros((r_pad, *msg.shape[1:])).index_add(0, rows, msg)
    return conv.finish(out, concat)


def gat_conv(conv: GATConv, x: torch.Tensor, adj, concat: bool,
             generator: Optional[torch.Generator], att_dropout: float,
             training: bool) -> torch.Tensor:
    """Attention over the batch's format: the hybrid pair (training), the
    forward-only hybrid (refresh) or the padded edge list."""
    if isinstance(adj, BiHybridAdj):
        return gat_conv_bi(conv, x, adj, concat, generator, att_dropout, training)
    if isinstance(adj, HybridAdj):
        if training and att_dropout > 0.0 and generator is not None:
            raise ValueError(
                "GAT training over forward-only hybrid batches cannot apply "
                "attention dropout; train on adj_format=hybrid or coo")
        return gat_conv_hybrid(conv, x, adj, concat)
    if isinstance(adj, PaddedAdj):
        return gat_conv_coo(conv, x, adj, concat, generator, att_dropout, training)
    raise ValueError(f"GAT aggregates over the hybrid and COO formats, not "
                     f"{type(adj).__name__} (its attention has no dense tier)")


class GAT(ScalableGNN):
    cfg: GATConfig

    def __init__(self, cfg: GATConfig, generator: Optional[torch.Generator] = None):
        """Parameters drawn on the CPU from ``generator``; move with ``.to``."""
        super().__init__(cfg)
        c = cfg
        wide = c.hidden_channels * c.hidden_heads
        convs = [GATConv(c.in_channels if i == 0 else wide, c.hidden_channels,
                         c.hidden_heads, generator) for i in range(c.num_layers - 1)]
        convs.append(GATConv(wide, c.out_channels, c.out_heads, generator))
        self.convs = nn.ModuleList(convs)

    @property
    def hist_dim(self) -> int:
        # the VR refresh caches the raw features in M_in[0]
        return max(self.cfg.in_channels, self.cfg.hidden_channels * self.cfg.hidden_heads)

    def layer_input_dim(self, layer: int) -> int:
        if layer == 0:
            return self.cfg.in_channels
        return self.cfg.hidden_channels * self.cfg.hidden_heads

    def reg_mask(self) -> Dict[str, bool]:
        """Every parameter is regularized (reference gat.py:39-40)."""
        return {name: True for name, _ in self.named_parameters()}

    def _conv(self, layer: int, x, adj, generator, training) -> torch.Tensor:
        concat = layer < self.cfg.num_layers - 1
        return gat_conv(self.convs[layer], x, adj, concat, generator,
                        self.cfg.dropout, training)

    # ---------------- GAS forward (reference gat.py:47-56) ----------------
    def forward_gas(self, x, batch, hist_emb, generator, training,
                    aggregate_combined=True, use_aggregation=True):
        """GAS training forward: each hidden layer's ELU output is pushed
        into ``hist_emb[l+1]`` and spliced with the pulled out-of-batch
        rows.  Returns ``(logits [R_pad, C], metrics)``."""
        c = self.cfg
        adj = batch.adj if aggregate_combined else batch.adj.mask_in_batch(batch.batch_size)
        for layer in range(c.num_layers - 1):
            x = dropout(x, c.dropout, training, generator)
            h = torch.nn.functional.elu(self._conv(layer, x, adj, generator, training))
            x = self.push_and_pull(hist_emb, layer + 1, h, batch)
        x = dropout(x, c.dropout, training, generator)
        out = self._conv(c.num_layers - 1, x, adj, generator, training)
        n_ib, n_ob = edge_counts(batch.adj, batch.batch_size)
        return out, {"num_in_batch_neighbors": n_ib, "num_out_batch_neighbors": n_ob}

    # ---------------- VR fallback (reference gat.py:383-398) ----------------
    def forward_vr(self, x, batch, hist: HistoryState, generator, training,
                   drift_norm: int = 2):
        """Attention has no linear VR decomposition: propagate plainly over
        the in-batch graph; the caches are not read and the drift is 0."""
        c = self.cfg
        for layer in range(c.num_layers - 1):
            x = dropout(x, c.dropout, training, generator)
            x = torch.nn.functional.elu(self._conv(layer, x, batch.adj, generator, training))
        x = dropout(x, c.dropout, training, generator)
        out = self._conv(c.num_layers - 1, x, batch.adj, generator, training)
        return out, {"drift": torch.zeros((), device=out.device)}

    # ---------------- layer-wise eval (reference gat.py:58-66) ----------------
    def forward_layer(self, layer, x, x0_ib, adj, use_aggregation=True, pre_agg=None):
        """One layer of the refresh sweep; attention cannot reuse the cached
        sum, so ``pre_agg`` is ignored."""
        h = self._conv(layer, x, adj, None, False)
        if layer < self.cfg.num_layers - 1:
            h = torch.nn.functional.elu(h)
        return h
