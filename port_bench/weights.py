"""The cells' initial weights, made by the benchmark from ``--seed``: one
draw on the run's device from a ``torch.Generator`` seeded with it, cut
into the model's parameters by name and shape, in f32.  The same tensors
go to the port and to the reference.

Each matrix (a parameter of two or more dimensions) is uniform in
``±sqrt(6 / (fan_in + fan_out))`` over its last two dimensions (Glorot),
each bias (a name ending in ``b``, ``_b`` or ``bias`` outside batch norm)
uniform in ``±1/sqrt(width)``; a batch norm's scale is 1 and its bias 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("bns."):
        return "bn_scale" if leaf == "scale" else "bn_bias"
    if leaf in ("b", "bias") or leaf.endswith("_b"):
        return "bias"
    return "matrix" if len(shape) >= 2 else "bias"


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for the parameters ``shapes`` (name -> shape, in order)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        kind = _kind(name, shape)
        if kind == "bn_scale":
            w = torch.ones(shape, device=device)
        elif kind == "bn_bias":
            w = torch.zeros(shape, device=device)
        elif kind == "matrix":
            w = u[at:at + n].view(shape) * math.sqrt(6.0 / (shape[-2] + shape[-1]))
        else:
            w = u[at:at + n].view(shape) * (1.0 / math.sqrt(shape[-1]))
        out[name] = w.contiguous()
        at += n
    return out
