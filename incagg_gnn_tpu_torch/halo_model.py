"""Halo traffic of the sharded trainer: the graph's lower bound against the plan.

The port's counterpart of ``scripts/halo_model.py`` (which loads JAX), read
from the port's host plan (``parallel/plan.py::build_plan``, the eval and
train ``HaloPlan``s; ``parallel/layout.py::edge_locality``) at the same
defaults.  It needs no ranks: the plan is host code.

1. The predicted lower bound of a layer pass: the unique (destination
   device, source node) pairs whose edge crosses devices under the layout
   (each such row must cross at least once), times the width and the
   element bytes.
2. The scheduled traffic of the plans: the true payload (send slots that
   are not the trash row; what the ``ragged`` wire moves) and the padded
   rows of the ``dense`` wire (``n_dev * (n_dev - 1) * H`` a round), per
   eval sweep (a refresh) and per GAS train epoch, against the prediction.
3. A projection of the payload over ``--link-gbps``, an assumed link
   bandwidth (default: the H100 SXM's NVLink 4 specification, 450 GB/s a
   direction, not a measurement); with ``--measure``, beside it the
   refresh seconds the port measured: ``spawn`` times refreshes of
   ``--n-devices`` ranks on ``--device`` (one spawn), a path reads the row
   of a ``scaling_bench`` artifact at that rank count.  Without
   ``--measure`` no refresh time is reported.

    python -m incagg_gnn_tpu_torch.halo_model --n-devices 8 --num-nodes 100000
    python -m incagg_gnn_tpu_torch.halo_model --n-devices 4 --hosts 2 \\
        --measure docs/scaling_port_r01.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from incagg_gnn_tpu_torch.scaling_bench import LINK_NOTE, NVLINK4_GBPS


def measured_refresh(measure: str, n_dev: int, hosts: int, args, prepared, arch,
                     trainer_kw) -> Optional[dict]:
    """The refresh seconds of ``n_dev`` ranks: timed in one spawn
    (``measure == "spawn"``), or read from a ``scaling_bench`` artifact's
    full leg at that rank count (its ``mesh2d`` row when ``hosts`` > 1)."""
    if measure == "spawn":
        from incagg_gnn_tpu_torch.parallel import mesh as M
        from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks
        from incagg_gnn_tpu_torch.scaling_bench import card_label, leg_rank

        backend = args.dist_backend or M.default_backend(args.device)
        devices = M.place_ranks(args.device, n_dev, backend)
        wire = "dense" if backend == "gloo" or n_dev == 1 else "ragged"
        res = spawn_ranks(leg_rank, n_dev, devices, backend,
                          args=(prepared, arch, trainer_kw, (wire,), (2, 3, 0.06)),
                          n_hosts=hosts, threads=max(1, (os.cpu_count() or 1) // n_dev))
        return {"refresh_s": res[0][wire]["refresh_s"],
                "refresh_all": res[0][wire]["refresh_all"],
                "source": f"one spawn of {n_dev} ranks on {args.device} over {backend} "
                          f"({card_label(devices[0])}), {wire} wire"}
    with open(measure) as f:
        art = json.load(f)
    rows = [art["mesh2d"]] if hosts > 1 and "mesh2d" in art else art["decomposition"]
    row = next((r for r in rows if r["devices"] == n_dev), None)
    if row is None:
        raise ValueError(f"{measure} has no row at {n_dev} ranks"
                         + (f" on {hosts} hosts" if hosts > 1 else ""))
    return {"refresh_s": row["refresh_s_full"],
            "source": f"{measure}: {art['platform']}"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch.halo_model")
    ap.add_argument("--n-devices", type=int, default=8)
    ap.add_argument("--num-nodes", type=int, default=100_000)
    ap.add_argument("--avg-degree", type=float, default=14.0)
    ap.add_argument("--num-parts", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--dtype-bytes", type=int, default=2,
                    help="bytes per halo element (bf16 caches = 2)")
    ap.add_argument("--link-gbps", type=float, default=NVLINK4_GBPS,
                    help="assumed link bandwidth, GB/s (default: the NVLink 4 "
                         "specification, not a measurement)")
    ap.add_argument("--measure", default=None, metavar="spawn|ARTIFACT",
                    help="beside the projection, the port's measured refresh seconds: "
                         "one spawn of --n-devices ranks, or a scaling_bench artifact")
    ap.add_argument("--device", default="cuda",
                    help="with --measure spawn: cuda:K (ranks sharing that card over "
                         "gloo), cuda, or cpu")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)
    if args.n_devices % args.hosts:
        ap.error(f"--hosts {args.hosts} does not divide {args.n_devices} devices")

    import numpy as np

    from incagg_gnn_tpu_torch.graph.datasets import make_sbm
    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.parallel.layout import edge_locality
    from incagg_gnn_tpu_torch.parallel.plan import PlanConfig, build_plan
    from incagg_gnn_tpu_torch.parallel.spatial import prepare_graph
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    data, in_c, out_c = make_sbm(num_nodes=args.num_nodes, num_classes=16,
                                 num_features=64, avg_degree=args.avg_degree, seed=0)
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=args.hidden,
                out_channels=out_c, num_layers=args.layers, dropout=0.0,
                drop_input=False)
    trainer_kw = dict(num_parts=args.num_parts, batch_size=1, vr_update=False, seed=0,
                      epochs=1)
    tcfg = TrainerConfig(**trainer_kw)
    prepared = prepare_graph(data, tcfg)
    nd, hosts = args.n_devices, args.hosts
    hist_dim = GCN(GCNConfig(**arch)).hist_dim
    plan = build_plan(prepared.data.adj_t, prepared.ptr,
                      PlanConfig.of("GCN", tcfg, hist_dim), nd, hosts)
    lay, slab = plan.layout, plan.layout.slab
    # the partition-permuted graph the plans were built from
    rowptr = np.asarray(prepared.data.adj_t.rowptr)
    col = np.asarray(prepared.data.adj_t.col)
    loc = edge_locality(lay, rowptr, col, prepared.ptr,
                        nd // hosts if hosts > 1 else nd)

    # 1. the lower bound: unique (destination device, source node) pairs
    d_of_node = lay.node_to_row // slab
    deg = np.diff(rowptr.astype(np.int64))
    d_src = d_of_node[np.repeat(np.arange(len(deg)), deg)]
    d_dst = d_of_node[col]
    cut = d_src != d_dst
    pred_rows = len(set(zip(d_src[cut].tolist(), col[cut].tolist())))
    d = args.hidden
    pred_mb = pred_rows * d * args.dtype_bytes / 1e6

    # 2. the scheduled traffic of the plans
    def plan_rows(halos):
        trash = lay.local_trash()
        true_rows = padded_rows = 0
        for per_round in halos:
            for h in per_round:
                true_rows += int((h.send_idx != trash).sum())
            n, width = per_round[0].send_idx.shape
            padded_rows += n * (n - 1) * width
        return true_rows, padded_rows

    eval_true, eval_pad = plan_rows(plan.eval.halos)
    train_true, train_pad = plan_rows(plan.train.halos)
    # a GAS epoch and a refresh each pull every round's halo once a layer
    per_set = {"eval_sweep": (eval_true, eval_pad, args.layers),
               "train_epoch": (train_true, train_pad, args.layers)}
    out = {
        "harness": "incagg_gnn_tpu_torch/halo_model.py",
        "graph": {"n": args.num_nodes, "edges": int(deg.sum()),
                  "avg_degree": args.avg_degree, "hidden": d, "n_devices": nd,
                  "hosts": hosts, "num_parts": args.num_parts,
                  "dtype_bytes": args.dtype_bytes},
        "edge_locality": {k: round(float(v), 4) for k, v in loc.items()},
        "predicted_rows_per_layer": pred_rows,
        "predicted_lower_bound_mb_per_sweep": round(pred_mb, 2),
        "link_gbps_assumed": args.link_gbps, "link_note": LINK_NOTE,
    }
    link = args.link_gbps * 1e9
    for name, (true_rows, pad_rows, layers) in per_set.items():
        true_mb = true_rows * d * args.dtype_bytes * layers / 1e6
        pad_mb = pad_rows * d * args.dtype_bytes * layers / 1e6
        out[name] = {
            "payload_rows_per_layer": true_rows,
            "padded_rows_per_layer": pad_rows,
            "scheduled_payload_mb": round(true_mb, 2),
            "wire_mb_dense": round(pad_mb, 2),
            "wire_mb_ragged": round(true_mb, 2),
            "wire_vs_payload_dense": round(pad_mb / max(true_mb, 1e-9), 3),
            "wire_vs_payload_ragged": 1.0,
            "payload_vs_predicted": round(true_mb / (pred_mb * layers), 3),
            "link_ms_at_assumed_bw": round(true_mb / nd * 1e6 / link * 1e3, 2),
        }
    if args.measure:
        m = measured_refresh(args.measure, nd, hosts, args, prepared, arch, trainer_kw)
        out["measured_refresh"] = m
        out["eval_sweep"]["link_ms_vs_measured_refresh"] = round(
            out["eval_sweep"]["link_ms_at_assumed_bw"] / (m["refresh_s"] * 1e3), 4)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
