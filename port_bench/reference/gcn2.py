"""GCNII (Chen et al. 2020, "Simple and Deep Graph Convolutional
Networks"), as PyG's ``GCN2Conv(normalize=False)``: for layer ``l`` with
``β_l = log(θ/(l+1) + 1)``::

    x̂  = (1 − α) · (A x)          x̂0 = α · x0
    shared:   out = (1 − β)(x̂ + x̂0) + β (x̂ + x̂0) W1
    unshared: out = (1 − β) x̂ + β x̂ W1 + (1 − β) x̂0 + β x̂0 W2

then batch norm (optional), the residual (optional) and ReLU;
``x0 = relu(lins.0(x))`` and the logits ``lins.1(h)``.  GAS training
aggregates a batch over its in-batch and out-of-batch rows, the latter
pulled from the history of the layer's input; Reverb (incremental
aggregation) over the in-batch graph only, ``A_ib (x − M_in) + M_ag``.

Weights are read by the port's parameter names: ``lins.0.w [F, H]``,
``lins.0.b``, ``lins.1.w [H, C]``, ``lins.1.b``, ``convs.<l>.w1 [H, H]``,
``convs.<l>.w2`` (unshared), ``bns.<l>.scale``, ``bns.<l>.bias``."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from port_bench.reference.graph import Sub, agg_sum


def hist_dim(arch: Dict, in_channels: int) -> int:
    """Width of the history caches (the layer inputs)."""
    return int(arch["hidden_channels"])


def reg_mask(name: str) -> bool:
    """convs and bns take the regularized weight decay, lins the other."""
    return not name.startswith("lins.")


def _lin(P, name, x):
    return x @ P[f"{name}.w"] + P[f"{name}.b"]


def _update(P, arch, l, agg, x0):
    beta = math.log(arch["theta"] / (l + 1) + 1.0)
    alpha = arch["alpha"]
    x_hat = (1.0 - alpha) * agg
    x0 = alpha * x0
    if arch["shared_weights"]:
        s = x_hat + x0
        return (1.0 - beta) * s + beta * (s @ P[f"convs.{l}.w1"])
    return ((1.0 - beta) * x_hat + beta * (x_hat @ P[f"convs.{l}.w1"])
            + (1.0 - beta) * x0 + beta * (x0 @ P[f"convs.{l}.w2"]))


def _post(P, arch, ctx, l, h, x_prev):
    if arch["batch_norm"]:
        h = ctx.bn(P, l, h)
    if arch["residual"]:
        h = h + x_prev[: h.shape[0]]
    return torch.relu(h)


def gas_forward(P, arch, ctx, x: torch.Tensor, a: Sub, hist) -> torch.Tensor:
    """Logits of the batch's in-batch rows; ``x`` the features of its
    ``a.cols`` columns (in-batch first), ``hist.push(l, h)`` writes the
    in-batch rows of layer ``l``'s input, ``hist.pull(l)`` reads its
    out-of-batch rows."""
    L, r = arch["num_layers"], a.rows
    if arch["drop_input"]:
        x = ctx.drop(x)
    x = x0 = torch.relu(_lin(P, "lins.0", x))
    x = ctx.drop(x)
    for l in range(L - 1):
        h = _post(P, arch, ctx, l, _update(P, arch, l, agg_sum(a, x), x0[:r]), x)
        hist.push(l + 1, h)
        x = ctx.drop(torch.cat([h, hist.pull(l + 1, h.shape[1])]))
    h = _post(P, arch, ctx, L - 1, _update(P, arch, L - 1, agg_sum(a, x), x0[:r]), x)
    return _lin(P, "lins.1", ctx.drop(h))


def vr_forward(P, arch, ctx, x: torch.Tensor, a: Sub, m_in: List, m_ag: List) -> torch.Tensor:
    """Logits of an in-batch graph's rows by the incremental aggregation;
    ``m_in[l]``/``m_ag[l]`` the batch rows of the caches."""
    if arch["drop_input"]:
        x = ctx.drop(x)
    x = x0 = torch.relu(_lin(P, "lins.0", x))
    x = ctx.drop(x)
    for l in range(arch["num_layers"]):
        d = x - m_in[l][:, : x.shape[1]]
        x_hat = agg_sum(a, d) + m_ag[l][:, : x.shape[1]]
        x = ctx.drop(_post(P, arch, ctx, l, _update(P, arch, l, x_hat, x0), x))
    return _lin(P, "lins.1", x)


@torch.no_grad()
def refresh(P, arch, ctx, x: torch.Tensor, a: Sub, vr: bool, hd: int):
    """The layer-wise refresh over the whole graph (eval mode): ``(M_in,
    M_ag, logits)``; ``M_in[0] = x0``, ``M_in[l+1]`` the output of layer
    ``l``, ``M_ag[l] = A M_in[l]`` (Reverb only; zeros in GAS)."""
    L = arch["num_layers"]
    m0 = torch.relu(_lin(P, "lins.0", x))
    m_in, m_ag = [m0], []
    for l in range(L):
        ag = agg_sum(a, m_in[l])
        m_ag.append(ag if vr else torch.zeros_like(ag))
        h = _post(P, arch, ctx, l, _update(P, arch, l, ag, m0), m_in[l])
        if l < L - 1:
            m_in.append(h)
    return m_in, m_ag, _lin(P, "lins.1", h)


def step_work(arch: Dict, in_c: int, out_c: int, shape, vr: bool):
    """(GEMM operations forward, aggregations forward, aggregations
    backward) of one training step on a batch of ``shape``
    (``counts.BatchShape``); an aggregation is ``(nnz, rows_in, rows_out,
    D)``.  Reverb trains on the in-batch graph.  The backward aggregation
    needs the gradient of every input row that takes one: every column at
    layer 0 (``lins.0`` runs on all of them in GAS), the in-batch columns
    after it (out-of-batch rows come from the history)."""
    L, H = arch["num_layers"], arch["hidden_channels"]
    r = shape.rows
    c = r if vr else shape.cols
    nnz = shape.nnz_ib if vr else shape.nnz
    per = 1 if arch["shared_weights"] else 2
    gemm = 2.0 * c * in_c * H + L * per * 2.0 * r * H * H
    gemm += 2.0 * r * H * out_c
    fwd = [(nnz, c, r, H)] * L
    bwd = [(nnz, r, c, H)] + [(shape.nnz_ib, r, r, H)] * (L - 1)
    return gemm, fwd, bwd


def refresh_work(arch: Dict, in_c: int, out_c: int, shapes, vr: bool, num_nodes: int):
    """(GEMM operations, aggregations) of one refresh over the eval batches
    ``shapes``: ``lins.0`` over every node once, each layer's aggregation
    and GEMMs per batch, ``lins.1`` on the last layer."""
    L, H = arch["num_layers"], arch["hidden_channels"]
    per = 1 if arch["shared_weights"] else 2
    gemm = 2.0 * num_nodes * in_c * H
    aggs = []
    for s in shapes:
        gemm += L * per * 2.0 * s.rows * H * H + 2.0 * s.rows * H * out_c
        aggs += [(s.nnz, s.cols, s.rows, H)] * L
    return gemm, aggs


#: dropout masks the GAS and Reverb forwards draw a step, in order, where
#: the dropout is on
def masks_per_step(arch: Dict, vr: bool) -> int:
    L = arch["num_layers"]
    return int(arch["drop_input"]) + 1 + L


class Model:
    """The model as ``reference/train.py`` drives it."""

    def __init__(self, arch: Dict, in_c: int, out_c: int, rowptr):
        self.arch, self.in_c, self.out_c = arch, in_c, out_c
        self.hist_dim = hist_dim(arch, in_c)

    def reg(self, name: str) -> bool:
        return reg_mask(name)

    def leaves(self, params: Dict) -> Dict:
        """The published parameters (here the port's, one for one)."""
        return dict(params)

    def gas(self, P, ctx, x, a, hist):
        return gas_forward(P, self.arch, ctx, x, a, hist)

    def vr(self, P, ctx, x, a, m_in, m_ag):
        return vr_forward(P, self.arch, ctx, x, a, m_in, m_ag)

    def refresh(self, P, ctx, x, a, vr):
        return refresh(P, self.arch, ctx, x, a, vr, self.hist_dim)

    def step_work(self, shape, vr):
        return step_work(self.arch, self.in_c, self.out_c, shape, vr)

    def refresh_work(self, shapes, vr, num_nodes):
        return refresh_work(self.arch, self.in_c, self.out_c, shapes, vr, num_nodes)

    def masks_per_step(self, vr):
        return masks_per_step(self.arch, vr)
