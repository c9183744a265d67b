"""Adversarial staleness stress suite of the PyTorch port.

The torch-only counterpart of ``scripts/staleness_stress.py``: the same
nine configurations and protocol on ``sbm-powerlaw-hard`` (power-law hubs
and 0.55 homophily put ~80% of the edges across partitions, so GAS and VR
pulls lean on the history caches and stale caches cost accuracy): GCN
3 x 64 with dropout 0.3 and BatchNorm, 32 parts, one cluster a batch, lr
0.01, dataset seed = trainer seed = run, for ``--epochs`` epochs;
per run the best test accuracy, the best of the first 5 and 10 epochs and
the epochs to a test accuracy of 0.85.  It drives every refresh schedule:
the full refresh after each epoch, a rotating ``refresh_frac`` window,
refreshes inside an epoch (a drift threshold, or a period), an EMA blend
of the refreshed caches (``hist_momentum``), and no aggregation at all.

    fresh            the default schedule (GAS and VR)
    stress           max_steps=8 of 32 + refresh_frac=0.25: clusters left
                     unvisited, caches and logits up to ~4 epochs stale
    stress-drift     + refresh_drift_threshold=2.0 (VR): adaptive refreshes
    stress-period3   + period_updates_in_one_epoch=3 (GAS): a blind schedule
    frac125          refresh_frac=0.125 alone
    frozen           hist_momentum=1e-4
    mlp              use_aggregation=false

The JSON at ``--out`` has the script's layout (``protocol``, and per
configuration the means and its ``runs``) plus the card (``device``) and,
per configuration, how its refreshes ran (``refresh``: the count of each
``_last_refresh_plan`` mechanism, eager warm-ups apart, and their seconds,
host clock around synchronised work).  With ``--compare`` each row is
printed beside the JAX package's record (``docs/staleness_stress_r04.json``)
on ``best`` and ``acc10``, flagged where ``|Δmean| > 2·sqrt(std_port² +
std_ref²) + 0.01``, the std over each record's ``runs``
(``accuracy_suite.py::compare``).

    python -m incagg_gnn_tpu_torch.staleness_stress --runs 2 --epochs 25 \\
        --out docs/staleness_stress_port_r01.json --compare docs/staleness_stress_r04.json
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import time

import numpy as np

from incagg_gnn_tpu_torch.accuracy_suite import compare

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESH = 0.85
STRESS = {"max_steps": 8, "refresh_frac": 0.25}
#: name: (vr_update, trainer-config overrides), as the JAX script has them
CONFIGS = {
    "gas-fresh": (False, {}),
    "vr-fresh": (True, {}),
    "gas-stress": (False, dict(STRESS)),
    "vr-stress": (True, dict(STRESS)),
    "vr-stress-drift": (True, {**STRESS, "refresh_drift_threshold": 2.0}),
    "gas-stress-period3": (False, {**STRESS, "period_updates_in_one_epoch": 3}),
    "gas-frac125": (False, {"refresh_frac": 0.125}),
    "gas-frozen": (False, {"hist_momentum": 1e-4}),
    "mlp": (False, {"use_aggregation": False}),
}
#: the metrics ``--compare`` holds against the reference
COMPARED = ("best", "acc10")


def timed_refreshes(model, sync):
    """``model.refresh`` wrapped to count each call's mechanism (from its
    plan; ``<mechanism>-warmup`` for an eager warm-up) and add its seconds
    (``sync`` ends the timed work).  Returns the counts and the seconds."""
    counts, seconds = collections.Counter(), [0.0]
    refresh = model.refresh

    def counted(*args, **kwargs):
        t = time.perf_counter()
        out = refresh(*args, **kwargs)
        sync()
        seconds[0] += time.perf_counter() - t
        plan = model._last_refresh_plan
        counts[plan["mechanism"] + ("-warmup" if plan.get("warmup") else "")] += 1
        return out

    model.refresh = counted
    return counts, seconds


def run_config(name: str, runs: int, epochs: int, dataset: str, device, root: str = "") -> dict:
    """One configuration over ``runs`` seeds: the JAX script's row, plus
    how its refreshes ran."""
    import torch

    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig

    vr, over = CONFIGS[name]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows, mechanisms, refresh_s = [], collections.Counter(), 0.0
    for run in range(runs):
        data, in_c, out_c = get_data(root, dataset, seed=run)
        cfg = GCNConfig(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=64,
                        out_channels=out_c, num_layers=3, dropout=0.3, drop_input=False,
                        batch_norm=True)
        tcfg = TrainerConfig(num_parts=32, batch_size=1, vr_update=vr, epochs=epochs,
                             lr=0.01, seed=run, log_every=1000, **over)
        t0 = time.perf_counter()
        model = GCN(cfg, generator=torch.Generator().manual_seed(run))
        trainer = Trainer(model, data, tcfg, device)
        counts, seconds = timed_refreshes(trainer.model, sync)
        res = trainer.fit()
        traj = [float(h["test_acc"]) for h in res["history"]]
        over_t = [i for i, a in enumerate(traj) if a >= THRESH]
        rows.append({"best": float(res["best_test"]), "acc5": max(traj[:5], default=0.0),
                     "acc10": max(traj[:10], default=0.0),
                     "epochs_to_thresh": (over_t[0] + 1) if over_t else None})
        mechanisms.update(counts)
        refresh_s += seconds[0]
        print(f"{name} run{run}: best {rows[-1]['best']:.4f} acc10 {rows[-1]['acc10']:.4f} "
              f"to{THRESH} {rows[-1]['epochs_to_thresh']} refreshes {dict(counts)} "
              f"{seconds[0]:.2f} s [{time.perf_counter() - t0:.1f} s]", flush=True)
        del trainer, model

    def agg(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return round(float(np.mean(vals)), 4)

    return {"best": agg("best"), "acc5": agg("acc5"), "acc10": agg("acc10"),
            "epochs_to_thresh": agg("epochs_to_thresh"), "runs": rows,
            "refresh": {"mechanisms": dict(mechanisms), "seconds": round(refresh_s, 4)}}


def stats(results: dict, key: str) -> dict:
    """``{row: {"mean", "std"}}`` of ``key`` over each row's ``runs``."""
    out = {}
    for name, row in results.items():
        vals = [r[key] for r in row["runs"]]
        out[name] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
    return out


def compare_rows(results: dict, reference: dict) -> list:
    """Each reference row beside the port's, on every metric of
    ``COMPARED``: ``(metric, row, port mean, port std, ref mean, ref std,
    Δ, band, flagged)`` (``accuracy_suite.compare``'s band)."""
    return [(key, *row) for key in COMPARED
            for row in compare(stats(results, key), stats(reference, key))]


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch.staleness_stress")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--dataset", default="sbm-powerlaw-hard")
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS))
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "staleness_stress.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    ap.add_argument("--compare", default=None,
                    help="a record of the same layout to hold the rows against "
                         "(docs/staleness_stress_r04.json)")
    args = ap.parse_args(argv)

    import torch

    from incagg_gnn_tpu_torch.__main__ import resolve_device

    device = resolve_device(args.device)
    unknown = [c for c in args.configs if c not in CONFIGS]
    if unknown:  # before any run
        raise ValueError(f"unknown configs {unknown}; the suite has {list(CONFIGS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count()} if device.type == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": 1}
    print(f"device: {card['kind']}", flush=True)
    protocol = {"dataset": args.dataset, "runs": args.runs, "epochs": args.epochs,
                "num_parts": 32, "batch_size": 1, "model": "gcn-3x64",
                "threshold": THRESH}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    for name in args.configs:
        results[name] = run_config(name, args.runs, args.epochs, args.dataset, device)
        with open(args.out, "w") as f:
            json.dump({"protocol": protocol, "device": card, "results": results}, f,
                      indent=1)
    rows = []
    if args.compare:
        with open(args.compare) as f:
            reference = json.load(f)["results"]
        rows = compare_rows(results, reference)
        print(f"{'metric':6s} {'row':20s} {'port':>15s} {'reference':>15s} "
              f"{'delta':>8s} {'band':>7s}")
        for key, row, pm, ps, rm, rs, delta, band, flagged in rows:
            port = "not run" if pm is None else f"{pm:.4f}±{ps:.4f}"
            tail = "" if pm is None else f" {delta:+8.4f} {band:7.4f}" + (
                "  FLAGGED" if flagged else "")
            print(f"{key:6s} {row:20s} {port:>15s} {rm:.4f}±{rs:.4f}{tail}")
    print("DONE", args.out)
    return {"protocol": protocol, "device": card, "results": results, "comparison": rows}


if __name__ == "__main__":
    main()
