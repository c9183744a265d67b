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

:func:`state_from_jax_checkpoint` carries a whole training state over: it reads
a checkpoint of the JAX package's single-device trainer (``ckpt_*.npz``,
the leaves of ``jax.tree.flatten`` of ``{"hist_emb", "hist_emb_ag",
"opt_state", "params", "rng", "state"}``, whose treedef string the sidecar
holds) into the port trainer's checkpoint entries, so that
``train/checkpoint.py::CheckpointManager`` resumes a JAX run in the port.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, List, Mapping, Sequence

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


_LOADERS = {
    "GCN": load_gcn_params, "GCN2": load_gcn2_params, "GraphSAGE": load_sage_params,
    "PNA": load_pna_params, "PNA_JK": load_pna_jk_params,
    "APPNP": lambda m, p, s: load_appnp_params(m, p),
    "GAT": lambda m, p, s: load_gat_params(m, p),
}


def load_params(model, params: Mapping, state: Mapping):
    """The loader of ``model``'s class (one of the functions above)."""
    name = model.__class__.__name__
    if name not in _LOADERS:
        raise NotImplementedError(f"no JAX parameter loader for {name}")
    return _LOADERS[name](model, params, state)


# ---------------- the JAX package's checkpoints ----------------
_TOKEN = re.compile(r"\s*(\*|None|'(?:[^'\\]|\\.)*'|[A-Za-z_][\w.]*|[{}()\[\],:=])")


def unflatten(treedef: str, leaves: Sequence[Any]):
    """The pytree that ``treedef`` (the ``str`` of a jax ``PyTreeDef``)
    describes, as nested dicts, lists and tuples, with ``leaves`` in
    flattening order.  A custom node such as an optax state becomes
    ``(type name, [children])``; ``None`` and empty states hold no leaf."""
    toks = _TOKEN.findall(treedef)
    pos = 0
    it = iter(leaves)

    def peek():
        return toks[pos]

    def take(want=None):
        nonlocal pos
        tok = toks[pos]
        if want is not None and tok != want:
            raise ValueError(f"unexpected {tok!r} (wanted {want!r}) in treedef")
        pos += 1
        return tok

    def seq(close):
        items = []
        while peek() != close:
            items.append(node())
            if peek() == ",":
                take(",")
        take(close)
        return items

    def node():
        tok = take()
        if tok == "*":
            return next(it)
        if tok == "None":
            return None
        if tok == "{":
            out = {}
            while peek() != "}":
                key = take()[1:-1]
                take(":")
                out[key] = node()
                if peek() == ",":
                    take(",")
            take("}")
            return out
        if tok == "[":
            return seq("]")
        if tok == "(":
            return tuple(seq(")"))
        if tok != "CustomNode":
            raise ValueError(f"unexpected {tok!r} in treedef")
        # CustomNode(namedtuple[Name], [children])
        take("(")
        kind, depth = [], 0
        while depth or peek() != ",":
            t = take()
            depth += (t == "[") - (t == "]")
            kind.append(t)
        take(",")
        take("[")
        children = seq("]")
        take(")")
        return (kind[-2] if len(kind) > 2 else kind[0], children)

    if take() != "PyTreeDef":
        raise ValueError("not a PyTreeDef string")
    take("(")
    tree = node()
    take(")")
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return tree


def _find_node(tree, kind: str):
    """The first custom node of type ``kind`` in ``tree``."""
    if isinstance(tree, tuple) and len(tree) == 2 and tree[0] == kind:
        return tree
    children = (tree.values() if isinstance(tree, dict) else
                tree if isinstance(tree, (list, tuple)) else ())
    for c in children:
        if isinstance(c, (dict, list, tuple)):
            found = _find_node(c, kind)
            if found is not None:
                return found
    return None


@torch.no_grad()
def _named_like_params(model, tree: Mapping, state: Mapping) -> Dict[str, torch.Tensor]:
    """A params-shaped JAX tree (Adam's ``mu`` or ``nu``) as the port's
    parameters, by name: loaded into a zeroed copy of ``model`` (PNA's
    stacking is elementwise, so it carries moments as it carries weights)."""
    scratch = copy.deepcopy(model)
    for p in scratch.parameters():
        p.zero_()
    load_params(scratch, tree, state)
    return {n: p.detach().clone() for n, p in scratch.named_parameters()}


def state_from_jax_checkpoint(trainer, leaves: List[np.ndarray], treedef: str,
                         epoch: int) -> Dict[str, Any]:
    """The port trainer's checkpoint entries (``Trainer.checkpoint_state``
    names) from a JAX single-device trainer checkpoint's ``leaves``.

    - ``params``/``state`` go through :func:`load_params`;
    - ``make_optimizer``'s chain holds one ``ScaleByAdamState(count, mu,
      nu)``; ``count`` is torch Adam's ``step`` (restored onto the
      parameters' device, where the capturable Adam of a CUDA trainer keeps
      it) and ``mu``/``nu`` its ``exp_avg``/``exp_avg_sq`` of the same
      parameter;
    - ``hist_emb``/``hist_emb_ag`` are the caches;
    - the JAX ``rng`` key cannot become a torch generator state: the
      device generator is reseeded from its bits (dropout draws differ
      between the packages anyway); a fused epoch registers that same
      generator with its CUDA graph, so its state is saved and restored
      as the step loop's is;
    - the training loader has run ``epoch + 1`` passes; the JAX package
      keeps neither its pad buckets (the port's loader keeps its own) nor a
      refresh cursor (0)."""
    tree = unflatten(treedef, leaves)
    model = trainer.model
    params, state = tree["params"], tree["state"] or {}
    scratch = copy.deepcopy(model)
    load_params(scratch, params, state)
    out: Dict[str, Any] = {f"model.{k}": v for k, v in scratch.state_dict().items()}
    adam = _find_node(tree["opt_state"], "ScaleByAdamState")
    if adam is None:
        raise ValueError("the JAX checkpoint's optimizer state holds no Adam state")
    count, mu, nu = adam[1]
    mus = _named_like_params(model, mu, state)
    nus = _named_like_params(model, nu, state)
    for name in mus:
        out[f"adam.{name}.step"] = np.float32(np.asarray(count))
        out[f"adam.{name}.exp_avg"] = mus[name]
        out[f"adam.{name}.exp_avg_sq"] = nus[name]
    for l, a in enumerate(tree["hist_emb"]):
        out[f"hist.emb.{l}"] = a
    for l, a in enumerate(tree["hist_emb_ag"]):
        out[f"hist.emb_ag.{l}"] = a
    key = np.asarray(tree["rng"]).astype(np.uint64).ravel()
    gen = torch.Generator(device=trainer.device)
    gen.manual_seed(int(key[0] << np.uint64(32) | key[-1]) if key.size else 0)
    out["generator"] = gen.get_state()
    out["loader_epoch"] = np.int64(epoch + 1)
    # the JAX file holds no pad buckets: keep the loader's own
    out["loader_buckets"] = np.asarray(
        dataclasses.astuple(trainer.train_loader.buckets), np.int64)
    out["refresh_cursor"] = np.int64(0)
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}
