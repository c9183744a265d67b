"""Rank functions of ``tests/test_torch_sharded.py``, run in processes
spawned by ``parallel/launch.py::spawn_ranks``.  This module imports torch
and the port only: every spawned rank imports it, and none of them should
load JAX."""

import numpy as np
import torch

from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
from incagg_gnn_tpu_torch.parallel.spatial import ShardedVRTrainer
from incagg_gnn_tpu_torch.parallel.spill_sharded import ShardedSpillVRTrainer
from incagg_gnn_tpu_torch.train.checkpoint import ShardedCheckpointManager
from incagg_gnn_tpu_torch.train.trainer import TrainerConfig


MODELS = {"GCN": (GCN, GCNConfig), "GCN2": (GCN2, GCN2Config), "GAT": (GAT, GATConfig),
          "PNA": (PNA, PNAConfig)}


def _model(name: str, arch: dict, params=None, state=None):
    cls, cfg = MODELS[name]
    m = cls(cfg(**arch))
    if params is not None:
        load_params(m, params, state)
    return m


def _params(tr) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tr.model.named_parameters()}


def _caches(tr) -> list:
    """Both caches of the rank's slab: the device tables, or the spill
    tier's host tables."""
    return [t.cpu().float().numpy() for k, t in tr.hist_arrays().items() if k != "generator"]


def _trainer(mesh, case, data, spill=False, **over):
    name, arch, kw, params, state = case
    cfg = TrainerConfig(**{**kw, **over})
    cls = ShardedSpillVRTrainer if spill else ShardedVRTrainer
    return cls(_model(name, arch, params, state), data, cfg, mesh)


def _first_grads(tr) -> dict:
    """Capture the reduced gradients of the trainer's next optimizer step."""
    got = {}
    step = tr.opt.step

    def capture():
        if not got:
            got.update({n: p.grad.detach().cpu().numpy().copy()
                        for n, p in tr.model.named_parameters()})
        step()

    tr.opt.step = capture
    return got


def _one_epoch(tr) -> dict:
    """The trainer's refresh logits, first-step gradients, and the loss,
    parameters and caches after one epoch."""
    logits = tr.refresh()
    grads = _first_grads(tr)
    loss = tr.train_epoch()["loss"]
    return {"logits": logits, "grads": grads, "params": _params(tr), "loss": loss,
            "caches": _caches(tr), "slab": tr.layout.slab}


def _resume(mesh, case, data, ckpt_dir: str, spill: bool) -> dict:
    """Save after epoch 0, then a fresh trainer restores and runs epoch 1
    beside the uninterrupted run's epoch 1."""
    full = _trainer(mesh, case, data, spill)
    full.refresh()
    ck = ShardedCheckpointManager(ckpt_dir, mesh)
    full.train_epoch()
    full.evaluate()
    ck.save(full, 0)
    full.epoch = 1
    l_full = full.train_epoch()["loss"]
    ev_full = full.evaluate()
    resumed = _trainer(mesh, case, data, spill)
    restored = ck.maybe_restore(resumed)
    start = resumed.epoch
    resumed.refresh()
    l_res = resumed.train_epoch()["loss"]
    ev_res = resumed.evaluate()
    return {"restored": restored, "start": start, "loss": (l_full, l_res),
            "eval": (ev_full, ev_res), "params": (_params(full), _params(resumed)),
            "caches": (_caches(full), _caches(resumed))}


def parity(mesh, cases: dict, data, ckpt_dir: str, spill=()) -> dict:
    """Each case's refresh logits, first-step gradients and parameters
    after one epoch, and for the cases in ``spill`` the same through the
    spill tier (``f"{tag}-spill"``), and the first of them at bfloat16
    caches in both tiers (``"bf16"``); the GAS case under both wires, its
    round-0 exchange forward and backward on random inputs, and a resumed
    run beside the uninterrupted one, with device caches and spilled."""
    torch.manual_seed(0)
    out = {"rank": mesh.rank}
    for tag, case in cases.items():
        out[tag] = _one_epoch(_trainer(mesh, case, data))
    for tag in spill:
        tr = _trainer(mesh, cases[tag], data, spill=True)
        out[f"{tag}-spill"] = {**_one_epoch(tr), "bytes": tr.spill_bytes()}
    if spill:
        out["bf16"] = {tier: _one_epoch(_trainer(mesh, cases[spill[0]], data, tier == "spill",
                                                 hist_dtype="bfloat16"))
                       for tier in ("device", "spill")}

    gas = cases["gcn-hybrid-gas"]
    wires = {}
    for wire in ("dense", "ragged"):
        tr = _trainer(mesh, gas, data, halo_wire=wire)
        logits = tr.refresh()
        caches = _caches(tr)
        tr.train_epoch()
        ex = tr._eval_halos[0]
        rng = np.random.default_rng(mesh.rank)
        src = torch.from_numpy(rng.standard_normal((tr.layout.slab, 5)).astype(np.float32))
        src.requires_grad_(True)
        res = ex(src)
        g = torch.from_numpy(rng.standard_normal(tuple(res.shape)).astype(np.float32))
        (d_src,) = torch.autograd.grad(res, src, g)
        wires[wire] = {"logits": logits, "caches": caches, "params": _params(tr),
                       "src": src.detach().numpy(), "g": g.numpy(),
                       "out": res.detach().numpy(), "d_src": d_src.numpy(),
                       "n_id": tr._eval[0].n_id.numpy(), "wire": tr.halo_wire,
                       "calls": dict(mesh.calls)}
    out["wires"] = wires

    out["resume"] = _resume(mesh, gas, data, ckpt_dir, spill=False)
    out["resume-spill"] = _resume(mesh, gas, data, ckpt_dir + "-spill", spill=True)
    return out


def failing(mesh) -> None:
    """Rank 1 fails; the others wait in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    from incagg_gnn_tpu_torch.parallel import mesh as M

    M.barrier(mesh)
