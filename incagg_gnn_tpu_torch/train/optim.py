"""Adam with reg/nonreg L2 groups (reference main.py:196-201).

Port of ``incagg_gnn_tpu/train/optim.py``: global-norm clipping first, then
the L2 decay added to the gradient, then the Adam moments — torch's ``Adam``
with ``weight_decay`` (not the decoupled ``AdamW``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class Optimizer:
    """``torch.optim.Adam`` over two parameter groups, with the clip."""

    def __init__(self, model: nn.Module, reg_mask: Dict[str, bool], lr: float,
                 reg_weight_decay: float = 0.0, nonreg_weight_decay: float = 0.0,
                 grad_norm: Optional[float] = None):
        named = dict(model.named_parameters())
        groups = [
            {"params": [p for n, p in named.items() if reg_mask[n]],
             "weight_decay": reg_weight_decay},
            {"params": [p for n, p in named.items() if not reg_mask[n]],
             "weight_decay": nonreg_weight_decay},
        ]
        self.params = list(named.values())
        self.names = list(named)
        self.grad_norm = grad_norm
        self.adam = torch.optim.Adam([g for g in groups if g["params"]], lr=lr)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            # a parameter the loss does not reach (e.g. an unused BatchNorm)
            # still takes the update of a zero gradient, as in optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.grad_norm)
        self.adam.step()

    def state_arrays(self) -> Dict[str, torch.Tensor]:
        """Adam's state per parameter name (``adam.<name>.step``,
        ``.exp_avg``, ``.exp_avg_sq``); zeros before the first step."""
        out = {}
        for name, p in zip(self.names, self.params):
            st = self.adam.state.get(p, {})
            out[f"adam.{name}.step"] = torch.as_tensor(
                float(st["step"]) if "step" in st else 0.0, dtype=torch.float32)
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"adam.{name}.{k}"] = st[k] if k in st else torch.zeros_like(p)
        return out

    @torch.no_grad()
    def load_state_arrays(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Restore what :meth:`state_arrays` returned."""
        for name, p in zip(self.names, self.params):
            step = float(arrays[f"adam.{name}.step"])
            if step == 0.0:
                self.adam.state.pop(p, None)
                continue
            self.adam.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": arrays[f"adam.{name}.exp_avg"].to(p).clone(),
                "exp_avg_sq": arrays[f"adam.{name}.exp_avg_sq"].to(p).clone(),
            }
