"""One process per rank: the launcher and the CLI's sharded run.

:func:`spawn_ranks` starts ``world`` processes (start method ``spawn``),
each joining the group through a ``file://`` rendezvous in a run
directory, runs ``fn(mesh, *args)`` in each and returns what each rank
returned.  The first rank that fails ends the run: the others are stopped
and :class:`RankFailed` carries that rank's exit code (``DEVICE_LOSS_EXIT``
on device loss, so a supervisor restarts the run as it restarts a
single-device one).  Under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` in the
environment) the CLI joins the group instead (:func:`join_ranks`).

:func:`run_sharded` is the CLI's ``--n-devices`` path, the counterpart of
``main.py:311-330, 349-407``: the placement and the memory gate, decided
once in the launcher, then :func:`run_rank` on every rank, which runs each
seed of ``--runs`` in turn.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp
from multiprocessing import connection as mp_connection

from incagg_gnn_tpu_torch.parallel import mesh as M

log = logging.getLogger("incagg_gnn_tpu_torch")


class RankFailed(RuntimeError):
    """A rank of a spawned run failed; ``code`` is its exit code."""

    def __init__(self, rank: int, code: int):
        super().__init__(f"rank {rank} failed with exit code {code}")
        self.rank, self.code = rank, code


def _rank_entry(call_path: str, rank: int, world: int, init_method: str, backend: str,
                device: str, n_hosts: int, out_path: str,
                threads: Optional[int]) -> None:
    """A spawned rank: load ``(fn, args)``, join the group, run ``fn``,
    write its result."""
    from incagg_gnn_tpu_torch.__main__ import DEVICE_LOSS_EXIT, _is_device_loss

    if threads:
        torch.set_num_threads(threads)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(message)s")
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        mesh = M.init_distributed(rank, world, init_method, backend, device, n_hosts)
        res = fn(mesh, *args)
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(out_path + ".tmp", out_path)
        # a failing rank leaves the group only by exiting, so that its exit
        # comes before the failures it causes in the others
        M.shutdown()
    except SystemExit:
        raise
    except BaseException as e:
        traceback.print_exc()
        sys.stderr.flush()
        sys.exit(DEVICE_LOSS_EXIT if _is_device_loss(e) else 1)


def spawn_ranks(fn: Callable, world: int, devices: Sequence, backend: str,
                args: tuple = (), n_hosts: int = 1, workdir: Optional[str] = None,
                threads: Optional[int] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks, rank ``r`` on
    ``devices[r]``; return the ranks' results in rank order.  ``fn`` must
    be importable by name (a module-level function)."""
    own = workdir is None
    # absolute: the file:// rendezvous takes no relative path
    workdir = tempfile.mkdtemp(prefix="incagg_ranks_") if own else os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "rendezvous")
    if os.path.exists(init):
        os.remove(init)  # a file rendezvous must start empty
    outs = [os.path.join(workdir, f"result-{r}.pkl") for r in range(world)]
    # the call goes through a file: a process's arguments travel through a
    # pipe that its start blocks on until the child has imported its main
    # module, so large ones would start the ranks one after another
    call = os.path.join(workdir, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(call, r, world, f"file://{init}", backend, str(devices[r]),
                               n_hosts, outs[r], threads))
             for r in range(world)]
    for p in procs:
        p.start()
    failed = None
    try:
        live = {p.sentinel: r for r, p in enumerate(procs)}
        while live and failed is None:
            # the ranks in the order they exit
            for s in mp_connection.wait(list(live)):
                r = live.pop(s)
                procs[r].join()
                if procs[r].exitcode != 0 and failed is None:
                    failed = (r, procs[r].exitcode)
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.exitcode is None:
                p.kill()
                p.join()
        os.remove(call)
    if failed is not None:
        raise RankFailed(*failed)
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    if own:
        shutil.rmtree(workdir, ignore_errors=True)
    return results


def join_ranks(fn: Callable, device: str, backend: str, args: tuple = (),
               n_hosts: int = 1):
    """Under ``torchrun``: this process's rank of ``fn(mesh, *args)``
    (``env://`` rendezvous; ``--device cuda`` takes ``cuda:LOCAL_RANK``)."""
    rank, world, local = M.env_rank()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    else:
        dev = M.place_ranks(device, world, backend)[rank]
    mesh = M.init_distributed(rank, world, "env://", backend, dev, n_hosts)
    try:
        return fn(mesh, *args)
    finally:
        M.shutdown()


# ---------------------------------------------------------------------------
# the CLI's sharded run
# ---------------------------------------------------------------------------

def memory_gate(model_cfg, hist_dim: int, hist_dtype: str, num_nodes: int,
                devices: Sequence) -> dict:
    """The counterpart of JAX's gate (``main.py:358-383``), decided once for
    all ranks: each rank's cache slab (2 x layers x slab rows x width),
    times the ranks placed on one card, against that card's free memory x
    0.8 (``torch.cuda.mem_get_info``; ``INCAGG_HBM_BUDGET_MB`` overrides it,
    on any device).  A device whose slabs are over it has ``spill`` set:
    the run keeps its caches in host memory
    (``parallel/spill_sharded.py``)."""
    from incagg_gnn_tpu_torch.history import resolve_dtype

    world = len(devices)
    itemsize = torch.empty((), dtype=resolve_dtype(hist_dtype)).element_size()
    slab = math.ceil((num_nodes + world) / world)
    per_rank = 2 * model_cfg.num_layers * slab * hist_dim * itemsize
    env = os.environ.get("INCAGG_HBM_BUDGET_MB")
    gate = {}
    for dev in sorted(set(str(d) for d in devices)):
        ranks = sum(str(d) == dev for d in devices)
        if env is not None:
            budget = int(env) << 20
        elif torch.device(dev).type == "cuda":
            budget = int(torch.cuda.mem_get_info(torch.device(dev))[0] * 0.8)
        else:
            continue
        need = per_rank * ranks
        gate[dev] = {"ranks": ranks, "cache_bytes": need, "budget_bytes": budget,
                     "slab_bytes": per_rank, "spill": need > budget}
    return gate


def spill_line(gate: dict) -> str:
    """The log line of a gate that chose the spill tier (JAX main.py:375-378)."""
    return "sharded spill tier: " + "; ".join(
        f"cache slab {g['slab_bytes'] >> 20} MB/device x {g['ranks']} on {dev} vs budget "
        f"{g['budget_bytes'] >> 20} MB" for dev, g in gate.items()
        ) + " — the caches stay in host memory"


def run_sharded(args, run_cfg, data, in_c: int, out_c: int, eval_graphs=None) -> dict:
    """``--n-devices N``: place the ranks, gate their memory, then run
    :func:`run_rank` on each (spawned, or joined under ``torchrun``).
    Returns rank 0's result with every rank's counters under ``ranks``."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.parallel.spatial import check_sharded
    from incagg_gnn_tpu_torch.train.spill_trainer import _check_spill

    env = M.env_rank()
    world = env[1] if env else args.n_devices
    backend = args.dist_backend or M.default_backend(args.device)
    if args.n_hosts < 1 or world % args.n_hosts:
        raise ValueError(f"--n-hosts {args.n_hosts} does not divide {world} ranks")
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    check_sharded(model, run_cfg.trainer)
    if args.spill:
        _check_spill(model, run_cfg.trainer)
    rank_args = (run_cfg, data, in_c, out_c, args.checkpoint_dir, args.eval_only,
                 args.save_logits, eval_graphs)
    if env:
        # the gate is decided on the ranks, each for its own device
        out = join_ranks(run_rank, args.device, backend,
                         rank_args + (True if args.spill else None, args.runs),
                         args.n_hosts)
        if env[0] == 0:
            log_runs(out)
        return out
    devices = M.place_ranks(args.device, world, backend)
    gate = memory_gate(model.cfg, model.hist_dim, run_cfg.trainer.hist_dtype,
                       data.num_nodes, devices)
    spill = args.spill or any(g["spill"] for g in gate.values())
    log.info(f"sharded run: {world} ranks over {backend} on "
             f"{', '.join(sorted(set(map(str, devices))))}; memory gate {gate}")
    if args.spill:
        log.info("sharded spill tier (--spill): the caches stay in host memory")
    elif spill:
        _check_spill(model, run_cfg.trainer)  # the tier the gate chose
        log.info(spill_line(gate))
    threads = max(1, (os.cpu_count() or 1) // world)
    results = spawn_ranks(run_rank, world, devices, backend,
                          rank_args + (spill, args.runs), args.n_hosts, threads=threads)
    out = dict(results[0])
    out["ranks"] = [r["rank_stats"] for r in results]
    log_runs(out)
    return out


def log_runs(out: dict) -> None:
    """With ``--runs`` > 1, each run's best val/test and their mean and
    spread, as the single-device loop logs them."""
    if "runs" not in out:
        return
    import numpy as np

    for r, res in enumerate(out["runs"]):
        log.info(f"run {r}: val {res['best_val']:.4f} test {res['best_test']:.4f}")
    vals = [r["best_val"] for r in out["runs"]]
    tests = [r["best_test"] for r in out["runs"]]
    log.info(f"{len(vals)} runs — Val: {np.mean(vals):.4f} ± {np.std(vals):.4f}, "
             f"Test: {np.mean(tests):.4f} ± {np.std(tests):.4f}")


def run_rank(mesh, run_cfg, data, in_c, out_c, checkpoint_dir=None, eval_only=False,
             save_logits=None, eval_graphs=None, spill: Optional[bool] = False,
             runs: int = 1) -> dict:
    """One rank of the CLI's sharded run: :func:`run_seed` once, or with
    ``runs`` > 1 once a seed, ``seed`` .. ``seed + runs - 1``, each run
    building its own trainer (partition, plan and parameters of its seed;
    JAX ``main.py:311-330``); returns each run's result and the means of
    their best val/test accuracies (:func:`log_runs` logs them)."""
    import numpy as np

    if runs == 1:
        return run_seed(mesh, run_cfg, data, in_c, out_c, checkpoint_dir, eval_only,
                        save_logits, eval_graphs, spill)
    base = run_cfg.trainer.seed
    results = []
    for r in range(runs):
        cfg = dataclasses.replace(run_cfg, trainer=dataclasses.replace(
            run_cfg.trainer, seed=base + r))
        results.append(run_seed(mesh, cfg, data, in_c, out_c, eval_graphs=eval_graphs,
                                spill=spill))
    return {"best_val": float(np.mean([r["best_val"] for r in results])),
            "best_test": float(np.mean([r["best_test"] for r in results])),
            "runs": results, "rank_stats": results[-1]["rank_stats"]}


def run_seed(mesh, run_cfg, data, in_c, out_c, checkpoint_dir=None, eval_only=False,
             save_logits=None, eval_graphs=None, spill: Optional[bool] = False) -> dict:
    """One run of the CLI's sharded path on this rank, ``run_once``'s loop
    over the sharded trainer (``spill``: the caches in host memory; None:
    decided here by the memory gate of this rank's device, the ranks
    agreeing): fill, then train and evaluate each epoch from the newest
    checkpoint on, saving one after each.  Rank 0 logs, runs the inductive
    evals and writes the logits; every rank returns its counters (kernel
    launches, collectives, wire bytes, peak memory, with ``spill`` the bytes
    staged each way after each phase)."""
    import numpy as np

    from incagg_gnn_tpu_torch.__main__ import _maybe_inject_fault, build_model
    from incagg_gnn_tpu_torch.ops.kernels import launch_counts
    from incagg_gnn_tpu_torch.parallel.spatial import ShardedVRTrainer
    from incagg_gnn_tpu_torch.parallel.spill_sharded import ShardedSpillVRTrainer
    from incagg_gnn_tpu_torch.train.checkpoint import ShardedCheckpointManager
    from incagg_gnn_tpu_torch.utils.metrics import compute_micro_f1

    if mesh.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(mesh.device)
    lead = mesh.rank == 0
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    if spill is None:
        gate = memory_gate(model.cfg, model.hist_dim, run_cfg.trainer.hist_dtype,
                           data.num_nodes, [mesh.device])
        over = any(g["spill"] for g in gate.values())
        spill = M.all_reduce_min(mesh, 0 if over else 1) == 0
        if spill and lead:
            log.info(spill_line(gate))
    t = time.perf_counter()
    cls = ShardedSpillVRTrainer if spill else ShardedVRTrainer
    trainer = cls(model, data, run_cfg.trainer, mesh, log=True)
    ckpt = None
    if checkpoint_dir:
        ckpt = ShardedCheckpointManager(checkpoint_dir, mesh)
        if ckpt.maybe_restore(trainer) and lead:
            log.info(f"resumed from checkpoint epoch {trainer.epoch - 1}")
    phases = {"setup_s": time.perf_counter() - t}
    launches, spilled = {}, {}

    def counters(phase: str) -> None:
        launches[phase] = launch_counts()
        if spill:
            spilled[phase] = trainer.spill_bytes()

    def inductive(ev: dict) -> dict:
        if eval_graphs is None or not lead:
            return ev
        val_data, test_data = eval_graphs
        return {**ev,
                "val_acc": compute_micro_f1(trainer.full_forward(val_data), val_data.y),
                "test_acc": compute_micro_f1(trainer.full_forward(test_data), test_data.y)}

    t = time.perf_counter()
    logits = trainer.fill_history()
    phases["fill_s"] = time.perf_counter() - t
    counters("fill")
    fill = inductive(trainer.metrics_from_logits(logits))
    if lead:
        log.info(f"history filled [{phases['fill_s']:.1f}s] train {fill['train_acc']:.4f} "
                 f"val {fill['val_acc']:.4f}")
    out = {"fill": fill, "phases": phases, "launches": launches,
           "formats": (trainer.plan.train.fmt, trainer.plan.eval.fmt),
           "halo_wire": trainer.halo_wire, "start_epoch": trainer.epoch,
           "tier": "spill" if spill else "device"}
    epochs = []
    if eval_only:
        if save_logits and lead:
            orig = np.empty_like(logits)
            orig[trainer.perm] = logits
            np.save(save_logits, orig)
        best_val, best_test = fill["val_acc"], fill["test_acc"]
    else:
        meta = trainer.restored_meta or {}
        best_val = float(meta.get("best_val", 0.0))
        best_test = float(meta.get("best_test", 0.0))
        phases["train_s"] = phases["eval_s"] = 0.0
        for epoch in range(trainer.epoch, run_cfg.trainer.epochs):
            t = time.perf_counter()
            tr = trainer.train_epoch()
            t_eval = time.perf_counter()
            counters(f"train{epoch}")
            ev = inductive(trainer.evaluate())
            phases["train_s"] += t_eval - t
            phases["eval_s"] += time.perf_counter() - t_eval
            counters(f"eval{epoch}")
            if ev["val_acc"] > best_val:
                best_val, best_test = ev["val_acc"], ev["test_acc"]
            epochs.append({"epoch": epoch, **tr, **ev})
            if lead and epoch % run_cfg.log_every == 0:
                log.info(f"Epoch {epoch:04d} loss {tr['loss']:.4f} "
                         f"train {ev['train_acc']:.4f} val {ev['val_acc']:.4f} "
                         f"test {ev['test_acc']:.4f} final {best_test:.4f} "
                         f"[{time.perf_counter() - t:.1f}s]")
            _maybe_inject_fault(epoch, checkpoint_dir)
            if ckpt is not None:
                ckpt.save(trainer, epoch, extra={"best_val": best_val,
                                                 "best_test": best_test})
            trainer.epoch = epoch + 1
        if lead:
            log.info("=========================")
            log.info(f"Val: {best_val:.4f}, Test: {best_test:.4f}")
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else 0)
    out.update(best_val=best_val, best_test=best_test, epochs=epochs, rank_stats={
        "rank": mesh.rank, "device": str(mesh.device), "launches": launch_counts(),
        "calls": dict(mesh.calls), "wire_bytes": mesh.wire_bytes, "peak_bytes": peak,
        "spill_bytes": spilled})
    return out
