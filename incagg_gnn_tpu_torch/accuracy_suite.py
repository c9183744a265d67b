"""Reference-protocol accuracy suite of the PyTorch port.

The torch-only counterpart of ``scripts/accuracy_suite.py``: the same
model configurations and protocol (``--runs`` repeats with dataset seed =
run seed = run, 16 parts, 4 clusters per batch, lr 0.01, the test accuracy
at the best validation epoch), trained through the port's ``run_once`` on
``--device`` (CUDA unless ``cpu`` is asked for), written as the same JSON
layout to ``--out``.  Each row is then printed beside the reference's band
from ``--reference`` (``docs/accuracy_suite_prod_r05.json``); a row is
flagged when ``|Δmean| > 2·sqrt(std_port² + std_ref²) + 0.01``.  A row
the reference file does not hold (``pna``) is printed with no band and
never flagged.

    python -m incagg_gnn_tpu_torch.accuracy_suite --runs 3 --epochs 20
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

import numpy as np

from incagg_gnn_tpu_torch.models.pna import compute_avg_deg

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's model names of the suite's keys
MODELS = {"gcn": "GCN", "gcn2": "GCN2", "appnp": "APPNP", "sage": "GraphSAGE", "gat": "GAT",
          "pna": "PNA"}


def architecture(model_name: str, data=None) -> dict:
    """The suite's configuration of a model (``scripts/accuracy_suite.py``
    ``build()``): hidden 64, dropout 0.3; PNA's degree statistics come from
    ``data``'s row degrees (``data`` is needed for PNA only)."""
    common = dict(hidden_channels=64, dropout=0.3)
    if model_name == "gcn":
        return dict(num_layers=3, drop_input=False, batch_norm=True, **common)
    if model_name == "gcn2":
        return dict(num_layers=4, drop_input=False, batch_norm=True, alpha=0.1, theta=0.5,
                    **common)
    if model_name == "appnp":
        return dict(num_layers=3, alpha=0.1, **common)
    if model_name == "sage":
        return dict(num_layers=3, drop_input=False, batch_norm=True, **common)
    if model_name == "gat":
        return dict(num_layers=2, hidden_heads=4, out_heads=1, **common)
    if model_name == "pna":
        lin, log = compute_avg_deg(np.diff(np.asarray(data.adj_t.rowptr)))
        return dict(num_layers=2, drop_input=False, avg_deg_lin=lin, avg_deg_log=log,
                    true_vr=True, **common)
    raise ValueError(model_name)


def run_row(dataset: str, model_name: str, vr: bool, runs: int, epochs: int,
            hist_dtype: str, device, root: str = "") -> list:
    """The best-val test accuracies of ``runs`` trainings of one row."""
    from incagg_gnn_tpu_torch.__main__ import run_once
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import RunConfig
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    accs = []
    for run in range(runs):
        data, in_c, out_c = get_data(root, dataset, seed=run)
        arch = architecture(model_name, data)
        tcfg = TrainerConfig(num_parts=16, batch_size=4, vr_update=vr, epochs=epochs,
                             lr=0.01, seed=run, log_every=1000, hist_dtype=hist_dtype)
        cfg = RunConfig(model=MODELS[model_name], dataset=dataset, root=root,
                        architecture=dict(arch), trainer=tcfg, log_every=1000)
        t0 = time.perf_counter()
        res = run_once(cfg, data, in_c, out_c, device)
        accs.append(float(res["best_test"]))
        print(f"{dataset} {model_name}-{'reverb' if vr else 'gas'}-{hist_dtype} "
              f"run{run}: {accs[-1]:.4f} [{time.perf_counter() - t0:.1f}s]", flush=True)
    return accs


def compare(results: dict, reference: dict) -> list:
    """Each reference row beside the port's: ``(key, port mean, port std,
    ref mean, ref std, Δ, band, flagged)``; a row the port did not run has
    None for its numbers."""
    rows = []
    for key, ref in reference.items():
        got = results.get(key)
        if got is None:
            rows.append((key, None, None, ref["mean"], ref["std"], None, None, None))
            continue
        delta = got["mean"] - ref["mean"]
        band = 2.0 * math.sqrt(got["std"] ** 2 + ref["std"] ** 2) + 0.01
        rows.append((key, got["mean"], got["std"], ref["mean"], ref["std"], delta, band,
                     abs(delta) > band))
    return rows


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch.accuracy_suite")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--datasets", nargs="+", default=["sbm-products-hard-v4"])
    ap.add_argument("--models", nargs="+", default=["gcn", "gcn2", "appnp"])
    ap.add_argument("--hist-dtypes", nargs="+", default=["float32"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    ap.add_argument("--reference",
                    default=os.path.join(_ROOT, "docs", "accuracy_suite_prod_r05.json"))
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "accuracy_suite.json"))
    args = ap.parse_args(argv)

    import torch

    from incagg_gnn_tpu_torch.__main__ import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unknown = [name for name in args.models if name not in MODELS]
    if unknown:  # before any run
        raise ValueError(f"unknown models {unknown}; the suite has {sorted(MODELS)}")
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}",
          flush=True)
    protocol = {"runs": args.runs, "epochs": args.epochs, "hidden": 64, "num_parts": 16,
                "batch_size": 4, "lr": 0.01, "hist_dtypes": args.hist_dtypes}
    results = {}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for ds in args.datasets:
        for model_name in args.models:
            for mode, vr in (("gas", False), ("reverb", True)):
                for hd in args.hist_dtypes:
                    accs = run_row(ds, model_name, vr, args.runs, args.epochs, hd, device)
                    key = f"{ds}/{model_name}-{mode}"
                    if len(args.hist_dtypes) > 1:
                        key += f"-{hd}"
                    results[key] = {"mean": round(float(np.mean(accs)), 4),
                                    "std": round(float(np.std(accs)), 4), "runs": accs}
                    with open(args.out, "w") as f:
                        json.dump({"protocol": protocol, "results": results}, f, indent=1)

    reference = {}
    if args.reference and os.path.exists(args.reference):
        with open(args.reference) as f:
            reference = json.load(f)["results"]
    rows = compare(results, reference)
    if rows:
        print(f"{'row':44s} {'port':>15s} {'reference':>15s} {'delta':>8s} {'band':>7s}")
    for key, pm, ps, rm, rs, delta, band, flagged in rows:
        port = "not run" if pm is None else f"{pm:.4f}±{ps:.4f}"
        tail = "" if pm is None else f" {delta:+8.4f} {band:7.4f}{'  FLAGGED' if flagged else ''}"
        print(f"{key:44s} {port:>15s} {rm:.4f}±{rs:.4f}{tail}")
    for key, got in results.items():
        if key not in reference:  # e.g. pna: the reference file has no such row
            print(f"{key:44s} {got['mean']:.4f}±{got['std']:.4f} no reference band")
    print("DONE", args.out)
    return {"protocol": protocol, "results": results, "comparison": rows}


if __name__ == "__main__":
    main()
