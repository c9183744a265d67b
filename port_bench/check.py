"""The comparison that decides ``correct``.

The run's set-up trains the port through the fill and ``EPOCHS`` epochs,
each the window's own ``train_epoch()`` and the ``evaluate()`` that
follows it; what they produced is recorded (:class:`Record`) before the
window.  The first epoch captures the CUDA graphs the window replays (on
the card its first step runs eagerly, the others replay the capture); the
second is made of replays alone, as every epoch of the window is.  After
the window, with the port's state freed, the plain reference
(``reference/train.py``) follows the same fill, epochs and refreshes from
the same weights and the same schedule, on its own state throughout, and
six numbers are compared, each with a limit of its own
(``limits/<cell>.json``):

- ``schedule``: faults in what the program fed the steps: a partition
  that is no permutation, an epoch whose in-batch rows do not cover every
  node once, a batch whose columns are not its rows and their one-hop
  neighbours, dropout masks of the wrong count, a looped epoch's count of
  steps (exact: limit 0);
- ``fill``: the logits of the fill (the first refresh, from the seed's
  weights), every node;
- ``loss``: the first epoch's first step's loss, relative (a later step's
  loss, and so an epoch's mean, carries what Adam made of the round-off
  of the steps before; a fused epoch on the card runs only its first step
  eagerly, so only that loss is known there);
- ``grad``: Adam's first moment after the last epoch (the gradients as the
  optimizer got them, clip included), leaf by leaf: the gap between the
  program's norm and the reference's over the larger of the reference's
  norm and the median leaf's, the worst leaf;
- ``change``: each parameter's change over the epochs, measured alike,
  the worst leaf;
- ``refresh``: every cache (``M_in`` and ``M_ag`` of each layer) and the
  logits table as the last epoch's refresh left them, every node, against
  the reference's refresh from its own parameters and batch-norm
  statistics after its own epochs.

Tables are compared through ``K`` fixed random projections of each row
(drawn from the seed), in float64: the widest gap of a row's projection
over the root mean square of the reference's projections in that table.
Leaves are the model's published parameters (a stacked parameter of the
port, such as PNA's branches, is cut into its branches:
``reference/<model>.py``'s ``leaves``).  A leaf whose reference gradient
is under a thousandth of the median leaf's (one the loss does not reach,
or a bias that a batch norm cancels) is left out of ``grad`` and
``change``: it moves by round-off alone.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: the compared numbers, in the order they are printed
NUMBERS = ("schedule", "fill", "loss", "grad", "change", "refresh")
#: epochs set-up trains and the check follows: the one that captures and
#: one of replays alone
EPOCHS = 2
#: projections a row is compared through
K = 4
#: rows a projection takes at a time
CHUNK = 1 << 16
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``grad`` and ``change``
TINY_LEAF = 1e-3


@dataclasses.dataclass
class Record:
    """What the program produced in the set-up's checked epochs, on the
    host, its rows in graph order; the lists hold one entry an epoch."""

    perm: np.ndarray  # program row i holds graph node perm[i]
    steps: List[List[Tuple[np.ndarray, int]]]  # (n_id, batch_size) of each batch, in order
    masks: List[List[torch.Tensor]]  # the dropout masks, in draw order
    fill: np.ndarray  # [N, K] projections of the fill's logits
    loss: float  # the first epoch's mean loss over the train rows
    step_losses: List[List[float]]  # the losses of the steps that ran eagerly, in order
    all_steps: bool  # whether ``step_losses`` holds every step's loss
    after: Dict[str, torch.Tensor]  # parameters after the last epoch
    exp_avg: Dict[str, torch.Tensor]  # Adam's first moment after the last epoch
    tables: Dict[str, np.ndarray]  # name -> [N, K] projections after the last refresh


def projector(widths, seed: int, device) -> Dict[int, torch.Tensor]:
    """One ``[width, K]`` Gaussian projection per table width, from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5EED)
    return {w: torch.randn((w, K), generator=gen, device=device, dtype=torch.float64)
            for w in sorted(set(widths))}


@torch.no_grad()
def project(t: torch.Tensor, v: Dict[int, torch.Tensor], order: Optional[torch.Tensor] = None
            ) -> np.ndarray:
    """``t``'s rows (on any device) projected (float64) on the projections'
    device, ``CHUNK`` rows at a time so that the check adds little to the
    device's peak, in graph order where ``order`` (``perm``) maps the
    program's rows to graph nodes."""
    w = v[t.shape[1]]
    p = torch.cat([t[i:i + CHUNK].to(w.device).double() @ w
                   for i in range(0, t.shape[0], CHUNK)])
    if order is not None:
        out = torch.empty_like(p)
        out[order] = p
        p = out
    return p.float().cpu().numpy()


def table_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    d = float(np.abs(prog.astype(np.float64) - ref.astype(np.float64)).max())
    rms = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    if rms == 0.0:
        return 0.0 if d == 0.0 else math.inf
    return d / rms


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep
              ) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, median leaf ‖ref‖)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    if not norms:
        return {}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keep}


def worst(gaps: Dict[str, float], n: int = 3) -> List[list]:
    """The ``n`` largest gaps, leaf and value."""
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def schedule_faults(perm: np.ndarray, epochs, num_nodes: int) -> int:
    """Faults of the partition and of each epoch's cover of the nodes."""
    faults = 0
    if perm.shape != (num_nodes,) or not np.array_equal(np.sort(perm), np.arange(num_nodes)):
        return num_nodes
    for steps in epochs:
        ib = np.concatenate([n_id[:bs] for n_id, bs in steps]) if steps else np.empty(0, int)
        faults += abs(len(ib) - num_nodes) + (num_nodes - len(np.unique(ib)))
    return int(faults)


def steps_of(rec: Record, epoch: int, device):
    """A recorded epoch's steps in graph ids, as the reference takes them."""
    from port_bench.reference.train import Step

    perm = torch.as_tensor(rec.perm, device=device)
    return [Step(perm[torch.as_tensor(n_id, device=device).long()], bs)
            for n_id, bs in rec.steps[epoch]]


def _epochs(ref, rec: Record, v: Dict[int, torch.Tensor]):
    """``ref`` through the recorded fill, epochs and refreshes: (the fill's
    projected logits, the first epoch's mean loss, schedule faults, each
    epoch's step losses, the last refresh's projected tables)."""
    fill = project(ref.refresh()["logits"], v)
    faults, losses, mean, tables = 0, [], math.nan, {}
    for e in range(len(rec.steps)):
        loss, f, ls = ref.train_epoch(steps_of(rec, e, ref.device), rec.masks[e])
        mean = loss if e == 0 else mean
        faults += f
        losses.append(ls)
        tables = ref.refresh()
    return fill, mean, faults, losses, {k: project(t, v) for k, t in tables.items()}


def follow(ref, rec: Record, v: Dict[int, torch.Tensor]) -> Dict:
    """The reference through the recorded fill and epochs: the fill's
    projected logits, the first epoch's loss, the schedule faults, each
    epoch's step losses, Adam's first moment and the parameters after the
    last epoch (on the host), the last refresh's projected tables."""
    fill, loss, faults, losses, tables = _epochs(ref, rec, v)
    return {"fill": fill, "loss": loss, "faults": faults, "losses": losses, "tables": tables,
            "m": {k: t.detach().cpu().clone() for k, t in ref.m.items()},
            "P": {k: t.detach().cpu().clone() for k, t in ref.P.items()}}


def compare(rec: Record, base: Dict, leaves, weights: Dict[str, torch.Tensor],
            detail: Optional[Dict] = None) -> Dict[str, float]:
    """The compared numbers of ``rec`` against the reference's run ``base``
    (:func:`follow`); ``leaves`` cuts parameters into the model's
    published leaves.  ``detail`` (a dict) receives the worst leaves and
    tables."""
    n = rec.perm.shape[0]
    faults = schedule_faults(rec.perm, rec.steps, n) + base["faults"]
    mean_gap = abs(rec.loss - base["loss"]) / max(abs(base["loss"]), 1e-30)
    if rec.all_steps:
        faults += sum(abs(len(p) - len(r)) for p, r in zip(rec.step_losses, base["losses"]))
    if rec.step_losses[0] and base["losses"][0]:
        first = base["losses"][0][0]
        loss = abs(rec.step_losses[0][0] - first) / max(abs(first), 1e-30)
    else:
        loss = math.nan
    out = {"schedule": float(faults), "fill": table_gap(rec.fill, base["fill"]), "loss": loss}
    split = leaves
    m_ref = split(base["m"])
    norms = {k: float(t.double().norm()) for k, t in m_ref.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k in m_ref if norms[k] >= TINY_LEAF * med]
    grad = leaf_gaps(split(rec.exp_avg), m_ref, keep)
    out["grad"] = max(grad.values(), default=0.0)
    w = {k: t.detach().cpu() for k, t in weights.items()}
    change = leaf_gaps(split({k: rec.after[k] - w[k] for k in w}),
                       split({k: base["P"][k] - w[k] for k in w}), keep)
    out["change"] = max(change.values(), default=0.0)
    tables = {k: table_gap(rec.tables[k], t) for k, t in base["tables"].items()}
    out["refresh"] = max(tables.values(), default=0.0)
    if detail is not None:
        detail.update(mean_loss=mean_gap, grad=worst(grad), change=worst(change),
                      refresh=worst(tables),
                      left_out=sorted(set(m_ref) - set(keep)))
    return {k: out[k] for k in NUMBERS}


def as_record(ref, rec: Record, v: Dict[int, torch.Tensor]) -> Record:
    """What ``ref`` (a reference in another precision or with a fault)
    produces in the program's place over the recorded fill, epochs and
    refreshes."""
    fill, loss, _, losses, tables = _epochs(ref, rec, v)
    after = {k: t.detach().cpu().clone() for k, t in ref.P.items()}
    m = {k: t.detach().cpu().clone() for k, t in ref.m.items()}
    return dataclasses.replace(rec, fill=fill, loss=loss, step_losses=losses,
                               after=after, exp_avg=m, tables=tables)


def load_limits(root: str, workload: str) -> Dict[str, float]:
    path = os.path.join(root, "port_bench", "limits", f"{workload}.json")
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number is within its limit (a missing limit fails)."""
    return all(k in limits and np.isfinite(v) and v <= limits[k] for k, v in values.items())
