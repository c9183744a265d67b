"""Small building blocks: linear with a ``[in, out]`` weight, BatchNorm over
valid rows, inverted dropout and edge dropout with an explicit generator,
padding helpers.
Port of ``incagg_gnn_tpu/models/nn.py``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` stored ``[in, out]`` (the JAX package's
    layout, so converted weights copy over as they are).  ``init`` "glorot"
    draws ``w`` uniform in ±sqrt(6/(in+out)), else ±sqrt(1/in); ``b`` uniform
    in ±sqrt(1/in)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 init: str = "kaiming", generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        limit = (math.sqrt(6.0 / (in_dim + out_dim)) if init == "glorot"
                 else math.sqrt(1.0 / in_dim))
        w = torch.empty(in_dim, out_dim, device=device)
        self.w = nn.Parameter(w.uniform_(-limit, limit, generator=generator))
        self.b = None
        if bias:
            b_limit = math.sqrt(1.0 / in_dim)
            b = torch.empty(out_dim, device=device)
            self.b = nn.Parameter(b.uniform_(-b_limit, b_limit, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float() @ self.w
        return y if self.b is None else y + self.b


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d whose batch statistics cover the valid rows only
    (``mask``), so padded rows do not shift them; ``nn.BatchNorm1d`` cannot
    mask rows.  Biased variance normalizes, the unbiased one updates the
    running estimate, as torch's BatchNorm1d does."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                training: bool) -> torch.Tensor:
        if training:
            if mask is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(dim=0)
                var = ((x - mean) ** 2).mean(dim=0)
            else:
                m = mask.to(x.dtype)[:, None]
                n = m.sum().clamp(min=1.0)
                mean = (x * m).sum(dim=0) / n
                var = (((x - mean) ** 2) * m).sum(dim=0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator (torch F.dropout
    semantics); identity when not training, ``p == 0`` or no generator.
    The mask is drawn on the device from ``generator``, which a fused epoch
    registers with its CUDA graph (``train/steps.py::EpochGraph``): every
    replay then draws a new mask, and the generator's state advances as
    the step loop's would."""
    if not training or p == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def edge_dropout(vals: torch.Tensor, p: float, training: bool,
                 generator: Optional[torch.Generator], weighted: bool,
                 keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DropEdge on a padded edge list's values: weighted adjacencies use
    inverted dropout on the values, binary ones drop entries without
    rescaling; identity when not training, ``p == 0`` or no generator.
    ``keep`` (bool, the shape of ``vals``) replaces the drawn keep mask.
    Drawn from ``generator`` on the device, as :func:`dropout` (a trainer
    with edge dropout trains the step loop: the JAX predicate keeps it
    out of the fused epoch)."""
    if not training or p == 0.0 or (generator is None and keep is None):
        return vals
    if keep is None:
        keep = torch.rand(vals.shape, generator=generator, device=vals.device) >= p
    if weighted:
        return torch.where(keep, vals / (1.0 - p), 0.0)
    return torch.where(keep, vals, 0.0)


def pad_rows(x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Zero-pad ``[R, D]`` to ``[num_rows, D]`` (R <= num_rows)."""
    if x.shape[0] == num_rows:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, num_rows - x.shape[0]))


def pad_cols(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-pad the feature dim to ``dim`` (the history width)."""
    if x.shape[1] == dim:
        return x
    return torch.nn.functional.pad(x, (0, dim - x.shape[1]))
