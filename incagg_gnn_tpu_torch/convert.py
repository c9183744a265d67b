"""Load the JAX package's model parameters into the port's models.

The JAX package keeps parameters as a pytree: GCN's ``params = {"convs":
[{"w", "b"}, ...], "bns": [{"scale", "bias"}, ...], "lins": [...]}``,
GCNII's ``{"convs": [{"w1"[, "w2"]}, ...], "bns": [...], "lins": [{"w",
"b"} x2]}``, GraphSAGE's ``{"convs": [{"lin_l": {"w", "b"}, "lin_r":
{"w"}}, ...], "bns": [...][, "lins": [...]]}``, APPNP's ``{"lins": [{"w",
"b"} x2]}``, GAT's ``{"convs": [{"w", "a_l", "a_r", "b"}, ...]}``, PNA's
``{"convs": [{"pre": [{"w", "b"}, ...], "post": [...], "lin": {"w", "b"}},
...], "bns": [...]}`` (PNA_JK's also ``"jk": {"w", "b"}``), and BatchNorm
running statistics as ``state = {"bns": [{"mean", "var"}, ...]}``.  Given those leaves as numpy arrays (``jax.tree.map(
np.asarray, ...)``), these fill a port model of the same configuration so
that both packages compute the same function.  Weights share the ``[in,
out]`` layout, so nothing is transposed; PNA's per-branch linears are
stacked in the port's branch order.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from incagg_gnn_tpu_torch.models.appnp import APPNP
from incagg_gnn_tpu_torch.models.gat import GAT
from incagg_gnn_tpu_torch.models.gcn import GCN
from incagg_gnn_tpu_torch.models.gcn2 import GCN2
from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE
from incagg_gnn_tpu_torch.models.pna import PNA
from incagg_gnn_tpu_torch.models.pna_jk import PNA_JK


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(src.shape)} into {tuple(dst.shape)}")
    dst.copy_(src)


def _check_depth(model, params: Mapping) -> None:
    if len(params["convs"]) != len(model.convs):
        raise ValueError(f"{len(params['convs'])} convs into a "
                         f"{len(model.convs)}-layer model")


@torch.no_grad()
def load_gcn_params(model: GCN, params: Mapping, state: Mapping) -> GCN:
    """Copy JAX ``params``/``state`` leaves into ``model`` in place and
    return it."""
    _check_depth(model, params)
    for conv, p in zip(model.convs, params["convs"]):
        _copy(conv.w, p["w"])
        _copy(conv.b, p["b"])
    _copy_bns_lins(model, params, state)
    return model


def _copy_bns_lins(model, params: Mapping, state: Mapping) -> None:
    for bn, p, s in zip(model.bns, params["bns"], state["bns"]):
        _copy(bn.scale, p["scale"])
        _copy(bn.bias, p["bias"])
        _copy(bn.running_mean, s["mean"])
        _copy(bn.running_var, s["var"])
    if "lins" in params:
        _copy_lins(model, params)


def _copy_lins(model, params: Mapping) -> None:
    for lin, p in zip(model.lins, params["lins"]):
        _copy(lin.w, p["w"])
        _copy(lin.b, p["b"])


@torch.no_grad()
def load_gcn2_params(model: GCN2, params: Mapping, state: Mapping) -> GCN2:
    """Copy JAX GCNII ``params``/``state`` leaves into ``model`` in place
    and return it."""
    _check_depth(model, params)
    for conv, p in zip(model.convs, params["convs"]):
        if ("w2" in p) != (conv.w2 is not None):
            raise ValueError("shared_weights differs between the parameters "
                             "and the model")
        _copy(conv.w1, p["w1"])
        if conv.w2 is not None:
            _copy(conv.w2, p["w2"])
    _copy_bns_lins(model, params, state)
    return model


@torch.no_grad()
def load_sage_params(model: GraphSAGE, params: Mapping, state: Mapping) -> GraphSAGE:
    """Copy JAX GraphSAGE ``params``/``state`` leaves into ``model`` in
    place and return it."""
    _check_depth(model, params)
    for conv, p in zip(model.convs, params["convs"]):
        _copy(conv.lin_l.w, p["lin_l"]["w"])
        _copy(conv.lin_l.b, p["lin_l"]["b"])
        _copy(conv.lin_r.w, p["lin_r"]["w"])
    _copy_bns_lins(model, params, state)
    return model


@torch.no_grad()
def load_appnp_params(model: APPNP, params: Mapping) -> APPNP:
    """Copy JAX APPNP ``params`` leaves (its MLP; its state is empty) into
    ``model`` in place and return it."""
    _copy_lins(model, params)
    return model


@torch.no_grad()
def load_gat_params(model: GAT, params: Mapping) -> GAT:
    """Copy JAX GAT ``params`` leaves (its state is empty) into ``model`` in
    place and return it."""
    _check_depth(model, params)
    for conv, p in zip(model.convs, params["convs"]):
        for name in ("w", "a_l", "a_r", "b"):
            _copy(getattr(conv, name), p[name])
    return model


@torch.no_grad()
def load_pna_params(model: PNA, params: Mapping, state: Mapping) -> PNA:
    """Copy JAX PNA ``params``/``state`` leaves into ``model`` in place and
    return it: branch ``order[p]``'s pre- and post-linear go to stacked
    position ``p``."""
    _check_depth(model, params)
    for conv, p in zip(model.convs, params["convs"]):
        if len(p["pre"]) != len(conv.order) or len(p["post"]) != len(conv.order):
            raise ValueError(f"{len(p['pre'])} branches into a conv of "
                             f"{len(conv.order)}")
        pre = [p["pre"][i] for i in conv.order]
        post = [p["post"][i] for i in conv.order]
        _copy(conv.pre_w, np.concatenate([np.asarray(q["w"]) for q in pre], axis=1))
        _copy(conv.pre_b, np.concatenate([np.asarray(q["b"]) for q in pre]))
        _copy(conv.post_w, np.stack([np.asarray(q["w"]) for q in post]))
        _copy(conv.post_b, np.stack([np.asarray(q["b"]) for q in post]))
        _copy(conv.lin_w, p["lin"]["w"])
        _copy(conv.lin_b, p["lin"]["b"])
    _copy_bns_lins(model, params, state)
    return model


@torch.no_grad()
def load_pna_jk_params(model: PNA_JK, params: Mapping, state: Mapping) -> PNA_JK:
    """:func:`load_pna_params` and the JK head."""
    load_pna_params(model, params, state)
    _copy(model.jk.w, params["jk"]["w"])
    _copy(model.jk.b, params["jk"]["b"])
    return model
