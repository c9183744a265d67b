"""Load the JAX package's GCN parameters into the port's model.

The JAX package keeps GCN parameters as a pytree ``params = {"convs": [{"w",
"b"}, ...], "bns": [{"scale", "bias"}, ...], "lins": [...]}`` and BatchNorm
running statistics as ``state = {"bns": [{"mean", "var"}, ...]}``.  Given
those leaves as numpy arrays (``jax.tree.map(np.asarray, ...)``), this fills
a :class:`~incagg_gnn_tpu_torch.models.gcn.GCN` of the same configuration so
that both packages compute the same function.  Weights share the ``[in,
out]`` layout, so nothing is transposed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from incagg_gnn_tpu_torch.models.gcn import GCN


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(src.shape)} into {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def load_gcn_params(model: GCN, params: Mapping, state: Mapping) -> GCN:
    """Copy JAX ``params``/``state`` leaves into ``model`` in place and
    return it."""
    if len(params["convs"]) != len(model.convs):
        raise ValueError(f"{len(params['convs'])} convs into a "
                         f"{len(model.convs)}-layer model")
    for conv, p in zip(model.convs, params["convs"]):
        _copy(conv.w, p["w"])
        _copy(conv.b, p["b"])
    for bn, p, s in zip(model.bns, params["bns"], state["bns"]):
        _copy(bn.scale, p["scale"])
        _copy(bn.bias, p["bias"])
        _copy(bn.running_mean, s["mean"])
        _copy(bn.running_var, s["var"])
    if "lins" in params:
        for lin, p in zip(model.lins, params["lins"]):
            _copy(lin.w, p["w"])
            _copy(lin.b, p["b"])
    return model
