"""The reference's training: the history caches, the GAS and Reverb steps,
the masked cross-entropy, the global-norm clip, L2 weight decay and Adam
(Kingma & Ba 2015, as ``torch.optim.Adam`` with ``weight_decay``), the
batch norm over the batch's rows, and the layer-wise refresh over the
whole graph, in plain PyTorch and f32.

What it is handed: the graph's arrays, the configuration, the initial
weights by name, and the schedule of each step: the step's columns (graph
ids, in-batch rows first), its in-batch count and the dropout masks its
forward draws, in draw order.  It derives the rest itself: the
adjacency's transforms and values, each batch's entries (and checks the
batch's columns against the graph), the caches, the gradients and the
optimizer's state.

``fault`` plants one of the faults a check must catch, in the reference
put in the program's place: ``half_batch`` (the loss over the first half
of the batch's train rows), ``frozen`` (no optimizer update) or ``alter``
(two rows of the refreshed logits swapped).  ``tf32`` computes every
matrix product in TF32, the precision below the configurations' f32.
"""

from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.graph import Adjacency

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BN_MOMENTUM, BN_EPS = 0.1, 1e-5
CLIP_EPS = 1e-6


class Step(NamedTuple):
    cols: torch.Tensor  # [C] graph ids, the in-batch rows first
    batch_size: int


class Ctx:
    """A forward's mode: dropout masks taken in order, batch norm over the
    batch's rows (training) or the running statistics (eval)."""

    def __init__(self, training: bool, p: float, masks: Optional[Iterator], bn_state):
        self.training, self.p, self.masks, self.bn_state = training, p, masks, bn_state

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = next(self.masks)[: x.shape[0], : x.shape[1]].to(x.device)
        return torch.where(keep, x / (1.0 - self.p), 0.0)

    def bn(self, P, l: int, h: torch.Tensor) -> torch.Tensor:
        rm, rv = self.bn_state[l]
        if self.training:
            n = h.shape[0]
            mean = h.mean(dim=0)
            var = ((h - mean) ** 2).mean(dim=0)
            with torch.no_grad():
                rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * n / max(n - 1, 1))
        else:
            mean, var = rm, rv
        return (h - mean) * torch.rsqrt(var + BN_EPS) * P[f"bns.{l}.scale"] + P[f"bns.{l}.bias"]


class _Hist:
    """A GAS step's view of the caches: pushes write the in-batch rows,
    pulls read the out-of-batch rows."""

    def __init__(self, tables: List[torch.Tensor], cols: torch.Tensor, r: int):
        self.tables, self.ib, self.ob = tables, cols[:r], cols[r:]

    def push(self, l: int, h: torch.Tensor) -> None:
        self.tables[l][self.ib, : h.shape[1]] = h.detach()

    def pull(self, l: int, width: int) -> torch.Tensor:
        return self.tables[l][self.ob, :width]


def load_model(cfg: Dict, in_c: int, out_c: int, rowptr: np.ndarray):
    """The configuration's reference model (``reference/<name>.py``)."""
    mod = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    return mod.Model(cfg["architecture"], in_c, out_c, rowptr)


class Reference:
    """Training and refresh from the seed's weights, in plain PyTorch."""

    def __init__(self, graph: Dict[str, np.ndarray], cfg: Dict, vr: bool,
                 weights: Dict[str, torch.Tensor], device, fault: str = "", tf32: bool = False):
        self.cfg, self.vr, self.fault, self.tf32 = cfg, vr, fault, tf32
        self.device = torch.device(device)
        tr = cfg["trainer"]
        self.adj = Adjacency(graph["rowptr"], graph["col"], loop=tr["loop"], norm=tr["norm"],
                             device=device)
        self.x = torch.as_tensor(graph["x"], device=device)
        self.y = torch.as_tensor(graph["y"], device=device).long()
        self.train_mask = torch.as_tensor(graph["train_mask"], device=device)
        in_c, out_c = self.x.shape[1], int(graph["y"].max()) + 1
        self.model = load_model(cfg, in_c, out_c, graph["rowptr"])
        self.P = {k: v.detach().clone().to(device).requires_grad_(True)
                  for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.t = 0
        L, H = cfg["architecture"]["num_layers"], cfg["architecture"]["hidden_channels"]
        self.bn_state = [(torch.zeros(H, device=device), torch.ones(H, device=device))
                         for _ in range(L)]
        self.m_in: List[torch.Tensor] = []
        self.m_ag: List[torch.Tensor] = []
        self.logits: Optional[torch.Tensor] = None

    @contextlib.contextmanager
    def _precision(self):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def refresh(self) -> Dict[str, torch.Tensor]:
        """The layer-wise refresh: every cache and the logits, by name."""
        ctx = Ctx(False, 0.0, None, self.bn_state)
        with self._precision():
            self.m_in, self.m_ag, self.logits = self.model.refresh(
                self.P, ctx, self.x, self.adj.full(), self.vr)
        if self.fault == "alter":
            self.logits[[0, 1]] = self.logits[[1, 0]]
        return self.tables()

    def tables(self) -> Dict[str, torch.Tensor]:
        out = {f"M_in.{l}": t for l, t in enumerate(self.m_in)}
        out.update({f"M_ag.{l}": t for l, t in enumerate(self.m_ag)})
        out["logits"] = self.logits
        return out

    def train_epoch(self, steps: List[Step], masks: List[torch.Tensor]):
        """The steps of one epoch (those whose batch has a train row), each
        taking its forward's dropout masks from ``masks`` in order; returns
        ``(mean loss over the train rows, schedule faults, each step's
        loss)``: a mask count other than the forwards draw is a fault."""
        arch = self.cfg["architecture"]
        per = self.model.masks_per_step(self.vr) if arch["dropout"] > 0 else 0
        kept = [s for s in steps if bool(self.train_mask[s.cols[: s.batch_size]].any())]
        faults = abs(len(masks) - per * len(kept))
        if faults:
            return math.nan, faults, []
        total = count = 0.0
        losses = []
        for i, s in enumerate(kept):
            with self._precision():
                loss, n, f = self._step(s, masks[i * per:(i + 1) * per])
            losses.append(loss)
            total += loss * n
            count += n
            faults += f
        return total / max(count, 1.0), faults, losses

    def _step(self, s: Step, masks: List[torch.Tensor]):
        model, arch = self.model, self.cfg["architecture"]
        nodes = s.cols[: s.batch_size]
        a, faults = self.adj.rows_of(nodes, s.cols, within=self.vr)
        if self.vr and s.cols.shape[0] != s.batch_size:
            faults += abs(s.cols.shape[0] - s.batch_size)
        ctx = Ctx(True, arch["dropout"], iter(masks), self.bn_state)
        if self.vr:
            logits = model.vr(self.P, ctx, self.x[nodes], a,
                              [t[nodes] for t in self.m_in], [t[nodes] for t in self.m_ag])
        else:
            logits = model.gas(self.P, ctx, self.x[s.cols], a,
                               _Hist(self.m_in, s.cols, s.batch_size))
        tm = self.train_mask[nodes]
        rows = tm.nonzero()[:, 0]
        n = int(rows.shape[0])
        if self.fault == "half_batch":
            rows = rows[: max(n // 2, 1)]
        loss = F.cross_entropy(logits[rows], self.y[nodes][rows])
        names = list(self.P)
        grads = torch.autograd.grad(loss, [self.P[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.P[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if self.fault != "frozen":
            self._adam(grads)
        return float(loss.detach()), float(n), faults

    @torch.no_grad()
    def _adam(self, grads: Dict[str, torch.Tensor]) -> None:
        tr = self.cfg["trainer"]
        if tr.get("grad_norm"):
            total = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
            coef = min(tr["grad_norm"] / (total + CLIP_EPS), 1.0)
            grads = {k: g * coef for k, g in grads.items()}
        self.t += 1
        b1, b2 = BETAS
        for k, p in self.P.items():
            wd = tr["reg_weight_decay"] if self.model.reg(k) else tr["nonreg_weight_decay"]
            g = grads[k] + wd * p if wd else grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p -= tr["lr"] * m_hat / (v_hat.sqrt() + ADAM_EPS)
