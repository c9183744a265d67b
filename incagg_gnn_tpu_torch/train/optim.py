"""Adam with reg/nonreg L2 groups (reference main.py:196-201).

Port of ``incagg_gnn_tpu/train/optim.py``: global-norm clipping first, then
the L2 decay added to the gradient, then the Adam moments — torch's ``Adam``
with ``weight_decay`` (not the decoupled ``AdamW``).  On CUDA the Adam is
``capturable``: its step counts are tensors on the parameters' device, so
a CUDA graph can replay the update (``train/steps.py::EpochGraph``).
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
        capturable = bool(self.params) and self.params[0].device.type == "cuda"
        self.adam = torch.optim.Adam([g for g in groups if g["params"]], lr=lr,
                                     capturable=capturable)

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
        """Adam's state per parameter name (``adam.<name>.step``, an f32
        scalar on the parameter's device, ``.exp_avg``, ``.exp_avg_sq``);
        zeros before the first step."""
        out = {}
        for name, p in zip(self.names, self.params):
            st = self.adam.state.get(p, {})
            step = st.get("step", torch.zeros((), dtype=torch.float32))
            out[f"adam.{name}.step"] = step.to(device=p.device, dtype=torch.float32)
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"adam.{name}.{k}"] = st[k] if k in st else torch.zeros_like(p)
        return out

    @torch.no_grad()
    def load_state_arrays(self, arrays: Dict[str, torch.Tensor]) -> None:
        """Restore what :meth:`state_arrays` returned (or a JAX checkpoint's
        Adam state, ``convert.state_from_jax_checkpoint``); the step counts
        go to the parameters' device, as the capturable Adam keeps them."""
        for name, p in zip(self.names, self.params):
            step = arrays[f"adam.{name}.step"]
            if float(step) == 0.0:
                self.adam.state.pop(p, None)
                continue
            self.adam.state[p] = {
                "step": torch.as_tensor(step, dtype=torch.float32).reshape(())
                .to(p.device).clone(),
                "exp_avg": arrays[f"adam.{name}.exp_avg"].to(p).clone(),
                "exp_avg_sq": arrays[f"adam.{name}.exp_avg_sq"].to(p).clone(),
            }
