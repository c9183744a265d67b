"""Training CLI of the PyTorch port (the counterpart of ``main.py``).

Usage:
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset sbm-arxiv [key=value ...]
    python -m incagg_gnn_tpu_torch --model conf/model/gcn.yaml --dataset sbm-small --device cpu vr_update=true
    python -m incagg_gnn_tpu_torch --model conf/model/gcn2.yaml --dataset sbm-products-mid epochs=1
    python -m incagg_gnn_tpu_torch --model conf/model/graphsage.yaml --dataset sbm-reddit-mid edge_dropout=0.2
    python -m incagg_gnn_tpu_torch --model conf/model/appnp.yaml --dataset arxiv dataset=sbm-arxiv
    python -m incagg_gnn_tpu_torch --model conf/model/gat.yaml --dataset arxiv dataset=sbm-arxiv
    python -m incagg_gnn_tpu_torch --model conf/model/pna.yaml --dataset arxiv dataset=sbm-arxiv [model=PNA_JK]

Overrides accept any TrainerConfig field or architecture key, as ``main.py``
does; ``dataset=<name>`` loads another graph than the one whose
hyperparameter block ``--dataset`` selects.  ``--device`` defaults to
``cuda``; the run refuses to start when CUDA is absent unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

log = logging.getLogger("incagg_gnn_tpu_torch")


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


def _launches() -> dict:
    from incagg_gnn_tpu_torch.ops import kernels as K

    return {name: getattr(K, name).launches for name in (
        "block_spmm", "ell_spmm", "hybrid_spmm", "hybrid_spmm_heads", "hybrid_max",
        "hybrid_max_bwd")}


def run_once(run_cfg, data, in_c, out_c, device) -> dict:
    """Fill the caches, then train and evaluate for the configured epochs.
    Returns the best val/test accuracy, every epoch's numbers, the seconds
    of each phase, the kernels' launch counters after each phase, the eval
    batches' dense-tile count and the (training, eval) loader formats."""
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    log.info(f"model: {run_cfg.model} {run_cfg.architecture} "
             f"trainer: {run_cfg.trainer}")
    t = time.perf_counter()
    trainer = Trainer(model, data, run_cfg.trainer, device, log=True)
    phases = {"setup_s": time.perf_counter() - t}

    t = time.perf_counter()
    logits = trainer.fill_history()
    phases["fill_s"] = time.perf_counter() - t
    launches = {"fill": _launches()}
    fill = trainer.metrics_from_logits(logits)
    tiles = trainer.eval_loader.dense_tiles()
    log.info(f"history filled [{phases['fill_s']:.1f}s] "
             f"train {fill['train_acc']:.4f} val {fill['val_acc']:.4f} "
             f"dense tiles {tiles}")

    best_val = best_test = 0.0
    epochs = []
    phases["train_s"] = phases["eval_s"] = 0.0
    for epoch in range(run_cfg.trainer.epochs):
        t = time.perf_counter()
        tr = trainer.train_epoch()
        t_eval = time.perf_counter()
        launches[f"train{epoch}"] = _launches()
        ev = trainer.evaluate()
        phases["train_s"] += t_eval - t
        phases["eval_s"] += time.perf_counter() - t_eval
        launches[f"eval{epoch}"] = _launches()
        if ev["val_acc"] > best_val:
            best_val, best_test = ev["val_acc"], ev["test_acc"]
        epochs.append({**tr, **ev})
        if epoch % run_cfg.log_every == 0:
            log.info(
                f"Epoch {epoch:04d} loss {tr['loss']:.4f} "
                f"train {ev['train_acc']:.4f} val {ev['val_acc']:.4f} "
                f"test {ev['test_acc']:.4f} final {best_test:.4f} "
                f"[{time.perf_counter() - t:.1f}s]")
    log.info("=========================")
    log.info(f"Val: {best_val:.4f}, Test: {best_test:.4f}")
    log.info("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    return {"best_val": best_val, "best_test": best_test, "fill": fill,
            "epochs": epochs, "phases": phases, "launches": launches,
            "dense_tiles": tiles,
            "formats": (trainer.train_loader.adj_format, trainer.eval_loader.adj_format)}


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
    ap.add_argument("overrides", nargs="*", help="key=value overrides")
    args = ap.parse_args(argv)

    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides

    device = resolve_device(args.device)
    # the reference multiplies in full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run_cfg = load_config(args.model, args.dataset, parse_overrides(args.overrides))
    run_cfg.root = args.root
    t = time.perf_counter()
    data, in_c, out_c = get_data(run_cfg.root, run_cfg.dataset)
    log.info(f"data: {run_cfg.dataset} N={data.num_nodes} E={data.adj_t.nnz} "
             f"F={in_c} C={out_c} [{time.perf_counter() - t:.1f}s]")

    if args.runs == 1:
        return run_once(run_cfg, data, in_c, out_c, device)
    results = []
    base_seed = run_cfg.trainer.seed
    for r in range(args.runs):
        run_cfg.trainer.seed = base_seed + r
        results.append(run_once(run_cfg, data, in_c, out_c, device))
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
