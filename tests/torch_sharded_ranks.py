"""Rank functions of ``tests/test_torch_sharded.py``, run in processes
spawned by ``parallel/launch.py::spawn_ranks``.  This module imports torch
and the port only: every spawned rank imports it, and none of them should
load JAX."""

import os

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


GCN_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "conf", "model",
                        "gcn.yaml")


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


def _serial_layer(tr):
    """A refresh layer pass as the serial loop, rebuilt from
    ``HaloExchange.collect`` / ``assemble`` and ``model._refresh_batch``:
    each round collects, then computes."""
    def layer_pass(layer, hist):
        src = tr.x_tab if layer == 0 else hist.emb[layer]
        for batch, ex in zip(tr._eval, tr._eval_halos):
            recv = ex.collect(src)
            tr.model._refresh_batch(layer, True, True, hist, tr.x_tab, tr.out_tab, batch,
                                    gather=lambda t, ex=ex, recv=recv: ex.assemble(t, recv))
    return layer_pass


def _serial_refresh(tr):
    """The logits and caches of a serial refresh of a copy of the trainer's
    state (the state is put back after)."""
    state = {k: v.clone() for k, v in tr.hist_arrays().items()}
    out_tab = tr.out_tab.clone()
    tr._refresh_layer = _serial_layer(tr)
    try:
        logits = tr.refresh()
        caches = _caches(tr)
    finally:
        del tr._refresh_layer
        tr.set_hist_arrays(state)
        tr.out_tab.copy_(out_tab)
    return {"logits": logits, "caches": caches}


def _one_epoch(tr) -> dict:
    """The trainer's refresh logits and caches beside a serial refresh's of
    the same state, the all-to-alls the refresh made, its first-step
    gradients, and the loss, parameters and caches after one epoch."""
    serial = _serial_refresh(tr)
    calls = tr.mesh.calls["all_to_all"]
    logits = tr.refresh()
    a2a = tr.mesh.calls["all_to_all"] - calls
    refresh_caches = _caches(tr)
    grads = _first_grads(tr)
    loss = tr.train_epoch()["loss"]
    return {"logits": logits, "grads": grads, "params": _params(tr), "loss": loss,
            "caches": _caches(tr), "slab": tr.layout.slab, "serial": serial,
            "refresh_caches": refresh_caches, "refresh_a2a": a2a,
            "layers_x_rounds": tr.model.cfg.num_layers * tr._eval_rounds}


def _order(tr) -> list:
    """The collects (by round) and the rounds computed (by layer) of one
    refresh, in the order the refresh issued them."""
    events = []
    for i, ex in enumerate(tr._eval_halos):
        collect = ex.collect_async
        ex.collect_async = lambda src, i=i, collect=collect: (
            events.append(("collect", i)), collect(src))[1]
    compute = tr.model._refresh_batch

    def counted(layer, *args, **kw):
        events.append(("compute", layer))
        return compute(layer, *args, **kw)

    tr.model._refresh_batch = counted
    try:
        tr.refresh()
    finally:
        del tr.model._refresh_batch
        for ex in tr._eval_halos:
            del ex.collect_async
    return events


def _runs(mesh, data) -> dict:
    """The CLI's sharded rank function with ``runs=2`` beside one run at
    each seed: GCN's ``sbm-small`` block, one epoch."""
    from incagg_gnn_tpu_torch.parallel.launch import run_rank
    from incagg_gnn_tpu_torch.train.config import load_config

    in_c, out_c = data.x.shape[1], int(data.y.max()) + 1
    cfg = load_config(GCN_YAML, "sbm-small", {"epochs": 1, "hidden_channels": 16})
    base = cfg.trainer.seed

    def single(seed):
        c = load_config(GCN_YAML, "sbm-small", {"epochs": 1, "hidden_channels": 16,
                                                 "seed": seed})
        return run_rank(mesh, c, data, in_c, out_c)

    def summary(res):
        return {"best_val": res["best_val"], "best_test": res["best_test"],
                "losses": [e["loss"] for e in res["epochs"]]}

    looped = run_rank(mesh, cfg, data, in_c, out_c, runs=2)
    return {"looped": [summary(r) for r in looped["runs"]],
            "mean": (looped["best_val"], looped["best_test"]),
            "single": [summary(single(base + r)) for r in range(2)]}


def _legs(mesh, data) -> dict:
    """One full and one loopback leg of ``scaling_bench`` on this graph."""
    from incagg_gnn_tpu_torch.parallel.spatial import prepare_graph
    from incagg_gnn_tpu_torch.scaling_bench import leg_rank

    kw = dict(num_parts=8, batch_size=1, vr_update=False, seed=0, epochs=1)
    prepared = prepare_graph(data, TrainerConfig(**kw))
    arch = dict(num_nodes=data.num_nodes, in_channels=data.x.shape[1], hidden_channels=16,
                out_channels=int(data.y.max()) + 1, num_layers=2, dropout=0.1,
                drop_input=False)
    return leg_rank(mesh, prepared, arch, kw, ("dense", "loopback"), (2, 2, 1.0), a2a=True)


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
    """Each case's refresh logits (beside a serial refresh's), first-step
    gradients and parameters after one epoch, and for the cases in
    ``spill`` the same through the spill tier (``f"{tag}-spill"``), and the
    first of them at bfloat16 caches in both tiers (``"bf16"``); the GAS
    case under each wire, its round-0 exchange forward and backward on
    random inputs, the order of one refresh's collects and rounds, and a
    resumed run beside the uninterrupted one, with device caches and
    spilled; the CLI's rank function with ``runs=2`` beside a run at each
    seed; one full and one loopback leg of ``scaling_bench``."""
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
    for wire in ("dense", "ragged", "loopback"):
        calls = dict(mesh.calls)
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
                       "calls": dict(mesh.calls),
                       "moved": {k: mesh.calls[k] - calls[k] for k in calls},
                       "plan": {k: getattr(ex, k).numpy() for k in (
                           "send_idx", "is_local", "local_pos", "remote_pos")}}
    out["wires"] = wires
    # 16 parts: four eval rounds a rank, so that collects run two rounds deep
    out["gcn-hybrid-gas-16"] = _one_epoch(_trainer(mesh, gas, data, num_parts=16))
    out["order"] = _order(_trainer(mesh, gas, data, num_parts=16))
    out["runs"] = _runs(mesh, data)
    out["legs"] = _legs(mesh, data)

    out["resume"] = _resume(mesh, gas, data, ckpt_dir, spill=False)
    out["resume-spill"] = _resume(mesh, gas, data, ckpt_dir + "-spill", spill=True)
    return out


def failing(mesh) -> None:
    """Rank 1 fails; the others wait in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    from incagg_gnn_tpu_torch.parallel import mesh as M

    M.barrier(mesh)
