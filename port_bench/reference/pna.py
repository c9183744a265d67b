"""PNA (Corso et al. 2020, "Principal Neighbourhood Aggregation"), as PyG's
``PNAConv`` without towers or edge features: for each branch ``(aggr,
scaler)`` a pre-linear and ReLU, the aggregation over the binarized
adjacency, a post-linear and the degree scaler, summed over the branches,
plus a root linear::

    out = Σ_b scaler_b(d) · (aggr_b(relu(x W_pre_b + b_pre_b)) W_post_b + b_post_b)
          + x W_lin + b_lin

with ``d`` the row's entry count, mean = sum / max(d, 1), max and min 0 on
a row with no entry, amplification ``log(d+1)/δ``, attenuation
``δ/(log(d+1) + 1e-5)``, ``δ`` the mean of ``log(deg+1)`` over the graph.
Layers before the last end in batch norm (optional), the residual
(optional) and ReLU.  GAS aggregates a batch over its in-batch and
out-of-batch rows; Reverb is the original's "mock" form: plain
propagation over the in-batch graph.

Weights are read by the port's parameter names, the branches stacked:
the sum and mean branches first, then max and min, each group in the
order aggregators × scalers of the configuration.  ``convs.<l>.pre_w [in,
nb·out]``, ``pre_b [nb·out]``, ``post_w [nb, out, out]``, ``post_b [nb,
out]``, ``lin_w [in, out]``, ``lin_b [out]``; ``bns.<l>.scale``,
``bns.<l>.bias``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench.reference.graph import Sub, agg_max, agg_min, agg_sum

EPS = 1e-5
_LINEAR = ("sum", "mean")


def hist_dim(arch: Dict, in_channels: int) -> int:
    """Width of the history caches (layer 0 caches the features)."""
    return max(in_channels, int(arch["hidden_channels"]))


def reg_mask(arch: Dict, name: str) -> bool:
    """Every layer but the last takes the regularized weight decay."""
    return not name.startswith(f"convs.{arch['num_layers'] - 1}.")


def stacked(arch: Dict):
    """(aggregator, scaler) at each stacked position."""
    br = [(a, s) for a in arch["aggregators"] for s in arch["scalers"]]
    return [b for b in br if b[0] in _LINEAR] + [b for b in br if b[0] not in _LINEAR]


def avg_deg_log(rowptr: np.ndarray) -> float:
    deg = np.diff(rowptr).astype(np.float64)
    return float(np.log(deg + 1).mean())


def _out_dim(arch, l, out_c):
    return out_c if l == arch["num_layers"] - 1 else arch["hidden_channels"]


def conv(P, arch, l: int, x: torch.Tensor, a: Sub, delta: float, out: int,
         chunk=None) -> torch.Tensor:
    pre = torch.relu(x @ P[f"convs.{l}.pre_w"] + P[f"convs.{l}.pre_b"])
    logd = torch.log(a.deg + 1)[:, None]
    y = x[: a.rows] @ P[f"convs.{l}.lin_w"] + P[f"convs.{l}.lin_b"]
    for p, (aggr, scaler) in enumerate(stacked(arch)):
        h = pre[:, p * out:(p + 1) * out]
        if aggr == "sum":
            g = agg_sum(a, h, binary=True)
        elif aggr == "mean":
            g = agg_sum(a, h, binary=True) / a.deg.clamp(min=1.0)[:, None]
        elif aggr == "max":
            g = agg_max(a, h, chunk)
        else:
            g = agg_min(a, h, chunk)
        t = g @ P[f"convs.{l}.post_w"][p] + P[f"convs.{l}.post_b"][p]
        if scaler == "amplification":
            t = t * (logd / delta)
        elif scaler == "attenuation":
            t = t * (delta / (logd + EPS))
        y = y + t
    return y


def _post(P, arch, ctx, l, h, x_prev):
    if arch["batch_norm"]:
        h = ctx.bn(P, l, h)
    if arch["residual"] and h.shape[-1] == x_prev.shape[-1]:
        h = h + x_prev[: h.shape[0]]
    return torch.relu(h)


def gas_forward(P, arch, ctx, x, a: Sub, hist, delta: float, out_c: int) -> torch.Tensor:
    L = arch["num_layers"]
    if arch["drop_input"]:
        x = ctx.drop(x)
    for l in range(L - 1):
        h = _post(P, arch, ctx, l, conv(P, arch, l, x, a, delta, _out_dim(arch, l, out_c)), x)
        hist.push(l + 1, h)
        x = ctx.drop(torch.cat([h, hist.pull(l + 1, h.shape[1])]))
    return conv(P, arch, L - 1, x, a, delta, out_c)


def vr_forward(P, arch, ctx, x, a: Sub, m_in: List, m_ag: List, delta: float,
               out_c: int) -> torch.Tensor:
    """The mock Reverb forward: plain propagation over the in-batch graph
    (the caches give only a drift that the loss does not see)."""
    L = arch["num_layers"]
    if arch["drop_input"]:
        x = ctx.drop(x)
    for l in range(L - 1):
        h = _post(P, arch, ctx, l, conv(P, arch, l, x, a, delta, _out_dim(arch, l, out_c)), x)
        x = ctx.drop(h)
    return conv(P, arch, L - 1, x, a, delta, out_c)


@torch.no_grad()
def refresh(P, arch, ctx, x, a: Sub, vr: bool, hd: int, delta: float, out_c: int,
            chunk: int = 1 << 18):
    """The layer-wise refresh over the whole graph (eval mode): ``M_in[0]``
    the features (Reverb; zeros in GAS), ``M_in[l+1]`` layer ``l``'s output,
    ``M_ag[l]`` the mean of ``M_in[l]`` over the neighbours (Reverb; zeros
    in GAS); every table ``hd`` wide, zero-padded."""
    L = arch["num_layers"]

    def pad(t):
        return torch.nn.functional.pad(t, (0, hd - t.shape[1]))

    m_in = [pad(x) if vr else x.new_zeros((x.shape[0], hd))]
    m_ag = []
    h = x
    for l in range(L):
        if vr:
            m_ag.append(pad(agg_sum(a, h, binary=True) / a.deg.clamp(min=1.0)[:, None]))
        else:
            m_ag.append(x.new_zeros((x.shape[0], hd)))
        y = conv(P, arch, l, h, a, delta, _out_dim(arch, l, out_c), chunk)
        if l < L - 1:
            h = _post(P, arch, ctx, l, y, h)
            m_in.append(pad(h))
    return m_in, m_ag, y


def _layer_work(arch, l, in_c, out_c):
    nb = len(stacked(arch))
    i = in_c if l == 0 else arch["hidden_channels"]
    o = _out_dim(arch, l, out_c)
    return i, o, nb


def step_work(arch: Dict, in_c: int, out_c: int, shape, vr: bool):
    """(GEMM operations forward, aggregations forward, aggregations
    backward) of one training step (see ``gcn2.step_work``).  Every
    column's pre-linear takes a gradient, so every layer's backward
    aggregation runs over all the batch's entries; the sum/mean group and
    the max/min group are one aggregation each."""
    r = shape.rows
    c = r if vr else shape.cols
    nnz = shape.nnz_ib if vr else shape.nnz
    gemm, fwd, bwd = 0.0, [], []
    for l in range(arch["num_layers"]):
        i, o, nb = _layer_work(arch, l, in_c, out_c)
        gemm += 2.0 * c * i * nb * o + 2.0 * r * nb * o * o + 2.0 * r * i * o
        n_lin = sum(1 for a, _ in stacked(arch) if a in _LINEAR)
        for width in (n_lin * o, (nb - n_lin) * o):
            if width:
                fwd.append((nnz, c, r, width))
                bwd.append((nnz, r, c, width))
    return gemm, fwd, bwd


def refresh_work(arch: Dict, in_c: int, out_c: int, shapes, vr: bool, num_nodes: int):
    """(GEMM operations, aggregations) of one refresh over the eval batches
    ``shapes``: each node's pre-linears once a layer (a batch that gathers
    its neighbours' rows recomputes theirs, which is not counted), each
    batch's aggregations, post-linears and root linear."""
    gemm, aggs = 0.0, []
    n_lin = sum(1 for a, _ in stacked(arch) if a in _LINEAR)
    for l in range(arch["num_layers"]):
        i, o, nb = _layer_work(arch, l, in_c, out_c)
        gemm += 2.0 * num_nodes * i * nb * o
    for s in shapes:
        for l in range(arch["num_layers"]):
            i, o, nb = _layer_work(arch, l, in_c, out_c)
            gemm += 2.0 * s.rows * nb * o * o + 2.0 * s.rows * i * o
            for width in (n_lin * o, (nb - n_lin) * o):
                if width:
                    aggs.append((s.nnz, s.cols, s.rows, width))
            if vr:
                aggs.append((s.nnz, s.cols, s.rows, i))
    return gemm, aggs


def masks_per_step(arch: Dict, vr: bool) -> int:
    return int(arch["drop_input"]) + arch["num_layers"] - 1


class Model:
    """The model as ``reference/train.py`` drives it; ``delta`` from the
    graph's degrees."""

    def __init__(self, arch: Dict, in_c: int, out_c: int, rowptr):
        self.arch, self.in_c, self.out_c = arch, in_c, out_c
        self.hist_dim = hist_dim(arch, in_c)
        self.delta = avg_deg_log(rowptr)

    def reg(self, name: str) -> bool:
        return reg_mask(self.arch, name)

    def leaves(self, params: Dict) -> Dict:
        """The published parameters: each stacked pre- and post-linear cut
        into its branches (``convs.<l>.pre_w.<p>`` for stacked position
        ``p``), the rest as they are."""
        out = {}
        nb = len(stacked(self.arch))
        for k, t in params.items():
            parts = k.split(".")
            if len(parts) == 3 and parts[0] == "convs" and parts[2] in (
                    "pre_w", "pre_b", "post_w", "post_b"):
                o = _out_dim(self.arch, int(parts[1]), self.out_c)
                kind = parts[2]
                for p in range(nb):
                    if kind == "pre_w":
                        out[f"{k}.{p}"] = t[:, p * o:(p + 1) * o]
                    elif kind == "pre_b":
                        out[f"{k}.{p}"] = t[p * o:(p + 1) * o]
                    else:
                        out[f"{k}.{p}"] = t[p]
            else:
                out[k] = t
        return out

    def gas(self, P, ctx, x, a, hist):
        return gas_forward(P, self.arch, ctx, x, a, hist, self.delta, self.out_c)

    def vr(self, P, ctx, x, a, m_in, m_ag):
        return vr_forward(P, self.arch, ctx, x, a, m_in, m_ag, self.delta, self.out_c)

    def refresh(self, P, ctx, x, a, vr):
        return refresh(P, self.arch, ctx, x, a, vr, self.hist_dim, self.delta, self.out_c)

    def step_work(self, shape, vr):
        return step_work(self.arch, self.in_c, self.out_c, shape, vr)

    def refresh_work(self, shapes, vr, num_nodes):
        return refresh_work(self.arch, self.in_c, self.out_c, shapes, vr, num_nodes)

    def masks_per_step(self, vr):
        return masks_per_step(self.arch, vr)
