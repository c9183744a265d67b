"""Training CLI of the PyTorch port (the counterpart of ``main.py``).

Usage:
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset sbm-arxiv [key=value ...]
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset sbm-small --device cpu vr_update=true
    python -m incagg_gnn_tpu_torch --model conf/model/gcn2.yaml --dataset sbm-products-mid epochs=1
    python -m incagg_gnn_tpu_torch --model conf/model/graphsage.yaml --dataset sbm-reddit-mid edge_dropout=0.2
    python -m incagg_gnn_tpu_torch --model conf/model/appnp.yaml --dataset arxiv dataset=sbm-arxiv
    python -m incagg_gnn_tpu_torch --model conf/model/gat.yaml --dataset arxiv dataset=sbm-arxiv
    python -m incagg_gnn_tpu_torch --model conf/model/pna.yaml --dataset arxiv dataset=sbm-arxiv [model=PNA_JK]
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset arxiv dataset=sbm-arxiv \
        --checkpoint-dir ck --supervise 2 [--spill] [--eval-only --save-logits out.npy]
    python -m incagg_gnn_tpu_torch --model conf/model/graphsage.yaml --dataset ppi --root <dir>
    python -m incagg_gnn_tpu_torch --model conf/model/graphsage.yaml --dataset sbm-small \
        --device cpu num_neighbors=10
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset sbm-small \
        --device cpu --n-devices 4 num_parts=8 [vr_update=true]
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset arxiv dataset=sbm-arxiv \
        --n-devices 4 --device cuda:0 --dist-backend gloo

Overrides accept any TrainerConfig field or architecture key, as ``main.py``
does; ``dataset=<name>`` loads another graph than the one whose
hyperparameter block ``--dataset`` selects; a name other than ``sbm-*``
loads the archive ``<root>/<name>/data.npz`` that ``python -m
incagg_gnn_tpu_torch.convert_dataset`` writes.  The inductive datasets
(``ppi``, ``sbm-ppi``) train on their training graph and report val/test
from whole-graph forwards on their separate val and test graphs
(reference main.py:167-175, 244-249).  ``--device`` defaults to
``cuda``; the run refuses to start when CUDA is absent unless ``--device
cpu`` is given.

``--n-devices N`` (N >= 2) shards the training over N ranks, one process
each (``parallel/launch.py``): ``--device cpu`` (gloo), ``--device cuda``
(rank r on ``cuda:r``, NCCL) or ``--device cuda:K --dist-backend gloo``
(every rank on one card); under ``torchrun`` the ranks are torchrun's.

``--checkpoint-dir`` saves the full training state after every epoch and
resumes from the newest checkpoint there (the port's or the JAX
package's); ``--supervise N`` runs the training in a child process and
restarts it from its newest checkpoint when it exits with
``DEVICE_LOSS_EXIT`` or its heartbeat goes stale; ``--spill`` keeps the
history caches in host memory (``train/spill_trainer.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

log = logging.getLogger("incagg_gnn_tpu_torch")

#: child exit code meaning "the device was lost mid-run" — the one failure
#: class the supervisor restarts from the newest checkpoint; every other
#: failure propagates
DEVICE_LOSS_EXIT = 23

#: what marks an exception as device loss on CUDA (``main.py`` lists PJRT's
#: statuses instead).  The watchdog's timeout; and the CUDA errors after
#: which the process's context is unusable ("sticky": every later call
#: fails the same way), so only a fresh process on the card can go on: an
#: illegal address (a wild kernel access or a failing card), a launch that
#: died or hit the driver's watchdog, and an uncorrectable memory (ECC)
#: error.  ``torch.cuda.OutOfMemoryError`` is deliberately not one: a
#: restart from the same checkpoint would run out of memory again, so it
#: propagates as a program error.
_DEVICE_LOSS_MARKERS = (
    "DeviceTimeoutError",
    "CUDA error: an illegal memory access",
    "unspecified launch failure",
    "uncorrectable ECC error",
)


def _is_device_loss(exc: BaseException) -> bool:
    """Whether ``exc`` is device loss (see ``_DEVICE_LOSS_MARKERS``) rather
    than an ordinary program error."""
    from incagg_gnn_tpu_torch.utils.watchdog import DeviceTimeoutError

    if isinstance(exc, DeviceTimeoutError):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    msg = f"{type(exc).__name__}: {exc}"
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def _maybe_inject_fault(epoch: int, ckpt_dir) -> None:
    """Fault injection for testing the recovery path (``main.py``'s).
    ``INCAGG_FAULT_INJECT=epoch=K`` raises a synthetic device-loss error
    the first time epoch K completes, before its checkpoint is saved
    (one-shot through a marker file in the checkpoint directory, so the
    restarted run goes on cleanly); ``hang_epoch=K`` hangs there instead,
    silently, which only the supervisor's stall watchdog can recover;
    ``always`` crashes at every epoch's end, a permanent failure that must
    exhaust the supervisor's retry budget."""
    spec = os.environ.get("INCAGG_FAULT_INJECT")
    if not spec:
        return
    if spec != "always":
        if not ckpt_dir:
            return
        kind, _, at = spec.partition("=")
        marker = os.path.join(ckpt_dir, ".fault_injected")
        if epoch != int(at) or os.path.exists(marker):
            return
        with open(marker, "w"):
            pass
        if kind == "hang_epoch":
            log.warning("INCAGG_FAULT_INJECT: hanging forever at epoch %d", epoch)
            while True:
                time.sleep(3600)
    raise RuntimeError("CUDA error: unspecified launch failure "
                       "(injected by INCAGG_FAULT_INJECT)")


def _child_argv(raw_argv):
    """``raw_argv`` without ``--supervise[=N]`` and ``--supervise-stall-s``,
    so that the child runs the plain training path."""
    out, skip = [], False
    for a in raw_argv:
        if skip:
            skip = False
            continue
        if a in ("--supervise", "--supervise-stall-s"):
            skip = True
            continue
        if a.startswith(("--supervise=", "--supervise-stall-s=")):
            continue
        out.append(a)
    return out


def _checkpoint_epoch(ckpt_dir: str) -> int:
    """The newest readable checkpoint sidecar's epoch, or -1.  Older
    sidecars are tried too: a crash can land mid-save, and reading progress
    as none would burn the retry budget of a run that is advancing."""
    import json

    try:
        metas = sorted((f for f in os.listdir(ckpt_dir) if f.endswith(".meta.json")),
                       reverse=True)
    except OSError:
        return -1
    for name in metas:
        try:
            with open(os.path.join(ckpt_dir, name)) as f:
                return int(json.load(f)["epoch"])
        except Exception:
            continue
    return -1


def _supervise(raw_argv, retries: int, ckpt_dir: str, stall_s: float = 1800.0) -> int:
    """Run the training CLI in a child process and relaunch it when it
    exits with ``DEVICE_LOSS_EXIT``; the child restores the newest
    checkpoint itself (``--checkpoint-dir``).  A fresh process is needed
    because a CUDA context that hit a sticky error cannot recover in
    process.  ``retries`` bounds consecutive restarts without checkpoint
    progress; a restart that advanced the saved epoch resets the budget."""
    import subprocess

    from incagg_gnn_tpu_torch.utils.heartbeat import ENV_VAR as HB_ENV

    os.makedirs(ckpt_dir, exist_ok=True)
    hb_path = os.path.join(ckpt_dir, ".heartbeat")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, HB_ENV: hb_path,
           "PYTHONPATH": os.pathsep.join(
               p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "incagg_gnn_tpu_torch", *_child_argv(raw_argv)]

    def run_child() -> int:
        """One attempt; killed (SIGKILL, exact pid) when its heartbeat goes
        stale — a wedge inside the runtime that no in-process watchdog can
        escape."""
        p = subprocess.Popen(cmd, env=env)
        start = time.time()
        poll_s = 10.0 if stall_s <= 0 else max(0.5, min(10.0, stall_s / 3))
        while True:
            try:
                return p.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                pass
            if stall_s <= 0:
                continue
            try:
                last = os.path.getmtime(hb_path)
            except OSError:
                last = start  # no beat yet: measure from launch
            # before the attempt's first beat the child is starting up
            # (imports, CUDA context, the kernels' load from build/,
            # partition, caching batches), where silence is legitimate:
            # grant a wider window then
            limit = stall_s if last > start else max(stall_s * 5.0, 60.0)
            if time.time() - max(last, start) > limit:
                log.error(f"supervisor: no heartbeat for {limit:.0f}s — killing "
                          f"stalled child {p.pid}")
                p.kill()
                p.wait()
                return DEVICE_LOSS_EXIT

    attempt, last_epoch = 0, _checkpoint_epoch(ckpt_dir)
    while True:
        rc = run_child()
        if rc != DEVICE_LOSS_EXIT:
            return rc
        epoch = _checkpoint_epoch(ckpt_dir)
        if epoch > last_epoch:
            attempt, last_epoch = 0, epoch  # progress: reset the budget
        attempt += 1
        if attempt > retries:
            log.error(f"supervisor: device lost {attempt} times with no checkpoint "
                      f"progress past epoch {last_epoch}; giving up")
            return DEVICE_LOSS_EXIT
        delay = min(60.0, 5.0 * attempt)
        log.warning(f"supervisor: device loss (attempt {attempt}/{retries}); "
                    f"restarting from checkpoint epoch {last_epoch} in {delay:.0f}s")
        time.sleep(delay)


def build_model(run_cfg, data, in_c: int, out_c: int, seed: int):
    """The configured model, its parameters drawn from ``seed``."""
    from incagg_gnn_tpu_torch.models.appnp import APPNP, APPNPConfig
    from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
    from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE, SAGEConfig
    from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig, compute_avg_deg
    from incagg_gnn_tpu_torch.models.pna_jk import PNA_JK, PNAJKConfig

    models = {"GCN": (GCN, GCNConfig), "GCN2": (GCN2, GCN2Config),
              "GraphSAGE": (GraphSAGE, SAGEConfig), "APPNP": (APPNP, APPNPConfig),
              "GAT": (GAT, GATConfig), "PNA": (PNA, PNAConfig),
              "PNA_JK": (PNA_JK, PNAJKConfig)}
    if run_cfg.model not in models:
        raise NotImplementedError(
            f"model {run_cfg.model}: the PyTorch port has {', '.join(models)} "
            f"so far (ROADMAP.md lists the rest)")
    model_cls, cfg_cls = models[run_cfg.model]
    arch = dict(run_cfg.architecture)
    if run_cfg.model.startswith("PNA"):
        # degree statistics of the scalers (reference main.py:181-182)
        lin_d, log_d = compute_avg_deg(data.adj_t.degrees())
        arch.setdefault("avg_deg_lin", lin_d)
        arch.setdefault("avg_deg_log", log_d)
        for key in ("aggregators", "scalers"):
            if key in arch:
                arch[key] = tuple(arch[key])
    cfg = cfg_cls(num_nodes=data.num_nodes, in_channels=in_c,
                  out_channels=out_c, **arch)
    gen = torch.Generator().manual_seed(seed)
    return model_cls(cfg, generator=gen)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu to run on the CPU")
    return device


def run_once(run_cfg, data, in_c, out_c, device, checkpoint_dir=None,
             spill: bool = False, eval_only: bool = False, save_logits=None,
             eval_graphs=None) -> dict:
    """Fill the caches, then train and evaluate for the configured epochs
    (from the newest checkpoint in ``checkpoint_dir`` on, saving one after
    every epoch), or with ``eval_only`` only evaluate.  Returns the best
    val/test accuracy, every epoch's numbers, the seconds of each phase, the
    kernels' launch counters after each phase, the eval batches' dense-tile
    count, the (training, eval) loader formats, whether the refresh ran over
    global columns and, with ``spill``, the bytes staged each way after each
    phase.  Each epoch's record says whether it trained fused.

    ``eval_graphs``, the ``(val, test)`` graphs of an inductive dataset:
    after the fill and after every evaluation, val and test are the
    micro-F1 of whole-graph forwards on them (``Trainer.full_forward``),
    their seconds summed in the phase ``inductive_s`` and the counters
    taken after each as the phases ``inductive_fill`` and
    ``inductive<epoch>``."""
    from incagg_gnn_tpu_torch.ops.kernels import launch_counts
    from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager
    from incagg_gnn_tpu_torch.train.trainer import Trainer
    from incagg_gnn_tpu_torch.utils.metrics import compute_micro_f1

    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    log.info(f"model: {run_cfg.model} {run_cfg.architecture} "
             f"trainer: {run_cfg.trainer}")
    t = time.perf_counter()
    if spill:
        from incagg_gnn_tpu_torch.train.spill_trainer import SpillVRTrainer

        trainer = SpillVRTrainer(model, data, run_cfg.trainer, device, log=True)
    else:
        trainer = Trainer(model, data, run_cfg.trainer, device, log=True)
    ckpt = None
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        if ckpt.maybe_restore(trainer):
            log.info(f"resumed from checkpoint epoch {trainer.epoch - 1}")
    phases = {"setup_s": time.perf_counter() - t}
    launches, spilled = {}, {}

    def counters(phase):
        launches[phase] = launch_counts()
        if spill:
            spilled[phase] = trainer.spill_bytes()

    def inductive_eval(ev: dict, phase: str) -> dict:
        """``ev`` with val/test from whole-graph forwards on the separate
        graphs (reference main.py:244-249)."""
        if eval_graphs is None:
            return ev
        t = time.perf_counter()
        val_data, test_data = eval_graphs
        ev = {**ev,
              "val_acc": compute_micro_f1(trainer.full_forward(val_data), val_data.y),
              "test_acc": compute_micro_f1(trainer.full_forward(test_data), test_data.y)}
        dt = time.perf_counter() - t
        phases["inductive_s"] = phases.get("inductive_s", 0.0) + dt
        counters(phase)
        log.info(f"inductive eval [{dt:.2f}s] val {ev['val_acc']:.4f} "
                 f"test {ev['test_acc']:.4f}")
        return {**ev, "inductive_s": dt}

    t = time.perf_counter()
    logits = trainer.fill_history()
    phases["fill_s"] = time.perf_counter() - t
    counters("fill")
    fill = inductive_eval(trainer.metrics_from_logits(logits), "inductive_fill")
    tiles = trainer.eval_loader.dense_tiles()
    log.info(f"history filled [{phases['fill_s']:.1f}s] "
             f"train {fill['train_acc']:.4f} val {fill['val_acc']:.4f} "
             f"dense tiles {tiles}")
    out = {"fill": fill, "phases": phases, "launches": launches, "dense_tiles": tiles,
           "formats": (trainer.train_loader.adj_format, trainer.eval_loader.adj_format),
           "global_cols": trainer.eval_loader.uses_global_cols,
           "spill_bytes": spilled}
    if eval_only:
        # the fill is the evaluation of the restored state
        log.info(f"eval-only: train {fill['train_acc']:.4f} "
                 f"val {fill['val_acc']:.4f} test {fill['test_acc']:.4f}")
        if save_logits:
            orig = np.empty_like(logits)
            orig[trainer.perm] = logits  # row i = original node i
            np.save(save_logits, orig)
            log.info(f"logits saved to {save_logits}")
        trainer.metrics.close()
        return {**out, "best_val": fill["val_acc"], "best_test": fill["test_acc"],
                "epochs": []}

    # the best so far comes back with a checkpoint, so that a supervised
    # restart reports the finals of the whole run
    meta = trainer.restored_meta or {}
    best_val = float(meta.get("best_val", 0.0))
    best_test = float(meta.get("best_test", 0.0))
    epochs = []
    phases["train_s"] = phases["eval_s"] = 0.0
    for epoch in range(trainer.epoch, run_cfg.trainer.epochs):
        t = time.perf_counter()
        tr = trainer.train_epoch()
        t_eval = time.perf_counter()
        counters(f"train{epoch}")
        ev = trainer.evaluate()
        phases["train_s"] += t_eval - t
        phases["eval_s"] += time.perf_counter() - t_eval
        counters(f"eval{epoch}")
        ev = inductive_eval(ev, f"inductive{epoch}")
        if ev["val_acc"] > best_val:
            best_val, best_test = ev["val_acc"], ev["test_acc"]
        epochs.append({"epoch": epoch, **tr, **ev})
        if epoch % run_cfg.log_every == 0:
            log.info(
                f"Epoch {epoch:04d} loss {tr['loss']:.4f} "
                f"train {ev['train_acc']:.4f} val {ev['val_acc']:.4f} "
                f"test {ev['test_acc']:.4f} final {best_test:.4f} "
                f"[{time.perf_counter() - t:.1f}s]")
        _maybe_inject_fault(epoch, checkpoint_dir)
        if ckpt is not None:
            ckpt.save(trainer, epoch, extra={"best_val": best_val, "best_test": best_test})
        trainer.epoch = epoch + 1
    trainer.metrics.close()
    log.info("=========================")
    log.info(f"Val: {best_val:.4f}, Test: {best_test:.4f}")
    log.info("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    return {**out, "best_val": best_val, "best_test": best_test, "epochs": epochs}


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch",
                                 allow_abbrev=False)
    ap.add_argument("--model", required=True, help="path to a conf/model YAML")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--root", default="/tmp/datasets")
    ap.add_argument("--runs", type=int, default=1,
                    help="repeat with seeds seed..seed+runs-1, report mean±std")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the full training state after every epoch and "
                         "resume from the newest checkpoint here (the port's "
                         "or the JAX package's)")
    ap.add_argument("--supervise", type=int, default=0, metavar="N",
                    help="run training in a child process and, on device loss "
                         "(exit code %d: a sticky CUDA error or the watchdog), "
                         "restart it from its newest checkpoint, up to N "
                         "consecutive times without checkpoint progress "
                         "(requires --checkpoint-dir)" % DEVICE_LOSS_EXIT)
    ap.add_argument("--supervise-stall-s", type=float, default=1800.0,
                    help="with --supervise: kill and restart the child when its "
                         "heartbeat is this long stale (five times as long, "
                         "and at least 60 s, before its first beat); 0 disables")
    ap.add_argument("--spill", action="store_true",
                    help="keep the history caches in pinned host memory, staged "
                         "through the C++ worker and a copy stream")
    ap.add_argument("--eval-only", action="store_true",
                    help="no training: fill the caches (after restoring the newest "
                         "checkpoint of --checkpoint-dir, if any) and report "
                         "train/val/test accuracy")
    ap.add_argument("--save-logits", default=None,
                    help="with --eval-only: write the full-graph logits, row i "
                         "for original node i, to this .npy path")
    ap.add_argument("--n-devices", type=int, default=0,
                    help="shard the training over N ranks, one process each "
                         "(parallel/spatial.py); 0 or 1 = one device.  Under "
                         "torchrun the ranks are torchrun's")
    ap.add_argument("--n-hosts", type=int, default=1,
                    help="with --n-devices: a (hosts x chips) mesh, whose layout "
                         "keeps the halo within hosts")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="with --n-devices: the process group's backend (default "
                         "nccl on cuda, gloo on cpu; ranks that share one card, "
                         "--device cuda:K, need gloo)")
    ap.add_argument("overrides", nargs="*", help="key=value overrides")
    # key=value overrides may sit between the flags
    args = ap.parse_intermixed_args(argv)
    if args.save_logits and not args.eval_only:
        ap.error("--save-logits requires --eval-only")
    if args.runs > 1 and (args.checkpoint_dir or args.eval_only):
        ap.error("--runs > 1 does not combine with --checkpoint-dir or --eval-only")

    if args.supervise > 0:
        if not args.checkpoint_dir:
            ap.error("--supervise requires --checkpoint-dir")
        raw = list(argv) if argv is not None else sys.argv[1:]
        rc = _supervise(raw, args.supervise, args.checkpoint_dir,
                        stall_s=args.supervise_stall_s)
        if rc != 0:
            sys.exit(rc)
        return {"supervised_rc": rc}

    from incagg_gnn_tpu_torch.parallel.launch import RankFailed

    try:
        return _main(args)
    except RankFailed as e:
        # the first failing rank's code: DEVICE_LOSS_EXIT on device loss
        log.error(str(e))
        sys.exit(e.code)
    except Exception as e:
        if _is_device_loss(e):
            # fail fast with the dedicated exit code; under --supervise the
            # run restarts from its newest checkpoint
            log.error(f"device loss: {type(e).__name__}: {e}")
            sys.exit(DEVICE_LOSS_EXIT)
        raise


def _main(args) -> dict:
    from incagg_gnn_tpu_torch.graph.datasets import INDUCTIVE_DATASETS, get_data
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides

    device = resolve_device(args.device)
    # the reference multiplies in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run_cfg = load_config(args.model, args.dataset, parse_overrides(args.overrides))
    run_cfg.root = args.root
    inductive = run_cfg.dataset.lower() in INDUCTIVE_DATASETS
    if inductive and args.spill:
        # the JAX SpillVRTrainer has no full_forward either
        raise NotImplementedError(
            f"--spill with the inductive dataset {run_cfg.dataset!r}: the spill "
            f"tier has no whole-graph forward for the val/test graphs")
    t = time.perf_counter()
    data, in_c, out_c = get_data(run_cfg.root, run_cfg.dataset)
    log.info(f"data: {run_cfg.dataset} N={data.num_nodes} E={data.adj_t.nnz} "
             f"F={in_c} C={out_c} [{time.perf_counter() - t:.1f}s]")
    # inductive datasets: val/test are separate graphs, evaluated with a
    # whole-graph forward (reference main.py:167-175, 244-249)
    eval_graphs = None
    if inductive:
        eval_graphs = tuple(get_data(run_cfg.root, run_cfg.dataset, split=split)[0]
                            for split in ("val", "test"))
        log.info(f"inductive eval graphs: val N={eval_graphs[0].num_nodes} "
                 f"test N={eval_graphs[1].num_nodes}")

    from incagg_gnn_tpu_torch.parallel.mesh import env_rank

    env = env_rank()
    if args.n_devices > 1 or (env is not None and env[1] > 1):
        from incagg_gnn_tpu_torch.parallel.launch import run_sharded

        return run_sharded(args, run_cfg, data, in_c, out_c, eval_graphs)
    if args.runs == 1:
        return run_once(run_cfg, data, in_c, out_c, device,
                        checkpoint_dir=args.checkpoint_dir, spill=args.spill,
                        eval_only=args.eval_only, save_logits=args.save_logits,
                        eval_graphs=eval_graphs)
    results = []
    base_seed = run_cfg.trainer.seed
    for r in range(args.runs):
        run_cfg.trainer.seed = base_seed + r
        results.append(run_once(run_cfg, data, in_c, out_c, device, spill=args.spill,
                                eval_graphs=eval_graphs))
        log.info(f"run {r}: val {results[-1]['best_val']:.4f} "
                 f"test {results[-1]['best_test']:.4f}")
    vals = [r["best_val"] for r in results]
    tests = [r["best_test"] for r in results]
    log.info(f"{args.runs} runs — Val: {np.mean(vals):.4f} ± {np.std(vals):.4f}, "
             f"Test: {np.mean(tests):.4f} ± {np.std(tests):.4f}")
    return {"best_val": float(np.mean(vals)), "best_test": float(np.mean(tests)),
            "runs": results}


if __name__ == "__main__":
    main()
