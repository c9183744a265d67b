"""Strong-scaling decomposition of the sharded trainer: full against loopback.

The port's counterpart of ``scripts/scaling_bench.py`` (which loads JAX),
with its method and its guards, over ``parallel/`` and ranks spawned by
``parallel/launch.py::spawn_ranks``.  For each rank count of ``--devices``
one spawn of that many ranks (one rank: this process) times, on one GCN
(``--layers`` x ``--hidden``) over an SBM graph made from ``--seed``:

1. ``T_full``: a train epoch (``--mode gas``: the halo-heavy case) and a
   refresh of ``ShardedVRTrainer`` over the real wire (``dense`` on gloo,
   ``ragged`` on NCCL; ``dense`` at world size 1, where ``ragged`` moves no
   rows);
2. ``T_loopback``: the same program with ``halo_wire=loopback`` (the same
   staging gathers and assembly reads, no collective), so ``T_full -
   T_loopback`` is the measured wire term;
3. at the largest rank count, an all-to-all alone at the exact ``HaloPlan``
   buffer shape (``[n_dev * H, D]`` a rank), its rate on this host.

Where the ranks share one card over gloo (``--device cuda:K``) the wire is
the host's (each CUDA buffer staged through host memory) and the rows say
so: they are not scaling.  ``--nccl-world1`` adds one row over NCCL at world
size 1 (no host wire).  ``--mesh2d HxC`` adds a ``(hosts x chips)`` row on
``H*C`` ranks with the hierarchical layout
(``parallel/layout.py::build_shard_layout_hierarchical``) and the measured
cross-host share of the graph's edges against the flat layout.

Guards, as in the JAX script: the run refuses to start when the host's
one-minute load exceeds ``--max-start-load``; each leg is timed until its
best two repetitions agree within ``--agree-tol`` (``--min-reps`` to
``--max-reps``; the time is the mean of the best two); a row whose
loopback is slower than its full leg, or a leg implicated by a cross-row
impossibility, is re-run once (the faster kept); a leg more than 1.3x
slower than the newest consistent prior artifact of the port
(``docs/scaling_port_r*.json``, never the JAX ``SCALING_r*.json``) is re-run
once and listed in ``suspect_legs`` if it stays slow; any issue left stamps
the artifact ``"valid": false`` with its reasons.

    python -m incagg_gnn_tpu_torch.scaling_bench --device cuda:0 --out docs/scaling_port_r01.json
    python -m incagg_gnn_tpu_torch.scaling_bench --device cpu --devices 1 2 \\
        --num-nodes 4000 --num-parts 8 --hidden 32 --mesh2d none --prior none

``--link-gbps`` is an assumed link bandwidth for the projection of the halo
bytes, by default the H100 SXM's NVLink 4 specification of 450 GB/s a
direction: a specification, not a measurement.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the assumed link bandwidth's default and its label
NVLINK4_GBPS = 450.0
LINK_NOTE = ("assumed, not measured: the H100 SXM's NVLink 4 specification, "
             "450 GB/s a direction")


# ---------------------------------------------------------------------------
# consistency checks, on fresh rows and on candidate prior artifacts (the
# JAX script's, verdict for verdict)
# ---------------------------------------------------------------------------

def _totals(r):
    return (r["train_s_full"] + r["refresh_s_full"],
            r["train_s_loopback"] + r["refresh_s_loopback"])


def row_issues(r) -> list:
    """Loopback runs a strict subset of the full program's work, so it
    cannot be slower (beyond 8%)."""
    full, loop = _totals(r)
    if loop > full * 1.08:
        return [f"nd={r['devices']}: loopback ({loop:.1f}s) slower than "
                f"full ({full:.1f}s) — loopback runs a strict subset of "
                f"the work"]
    return []


def cross_row_issues(rows, cores) -> list:
    """Cross-leg impossibilities at known core ceilings: total work is
    fixed, so between two legs at the same ceiling the larger mesh can only
    add sharding overhead (its loopback time cannot shrink), and no leg can
    beat the one-rank leg by more than the core ratio."""
    out = []
    by_nd = {r["devices"]: r for r in rows}
    ordered = sorted(by_nd)
    for a, b in zip(ordered, ordered[1:]):
        ca = min(a, cores)
        cb = min(b, cores)
        la, lb = _totals(by_nd[a])[1], _totals(by_nd[b])[1]
        if ca == cb and lb < la * 0.97:
            out.append((a,
                f"nd={a}: loopback ({la:.1f}s) slower than nd={b}'s "
                f"({lb:.1f}s) at the same {ca}-core ceiling — sharding "
                f"overhead cannot decrease with more shards; the nd={a} "
                f"capture is inflated"))
    if 1 in by_nd:
        l1 = _totals(by_nd[1])[1]
        for nd in ordered:
            if nd == 1:
                continue
            ln = _totals(by_nd[nd])[1]
            ratio_max = min(nd, cores) * 1.05
            if ln < l1 / ratio_max:
                out.append((1,
                    f"nd={nd}: loopback ({ln:.1f}s) beats nd=1 "
                    f"({l1:.1f}s) by more than the {min(nd, cores)}x core "
                    f"ratio — the nd=1 capture is inflated"))
    return [m for _, m in out]


def cross_row_flags(rows, cores) -> list:
    """:func:`cross_row_issues` with the implicated (inflated) rank count of
    each, so that exactly that leg is re-run."""
    flags = []
    for m in cross_row_issues(rows, cores):
        nd = int(re.search(r"the nd=(\d+) capture is inflated", m).group(1))
        flags.append((nd, m))
    return flags


def artifact_issues(art: dict, cores=None) -> list:
    """Every row's and every pair's issues of an artifact (``cores`` read
    from its platform label when not given)."""
    rows = art.get("decomposition", [])
    out = []
    for r in rows:
        out.extend(row_issues(r))
    if cores is None:
        m = re.search(r"(\d+) (?:physical|host CPUs)", art.get("platform", ""))
        cores = int(m.group(1)) if m else (os.cpu_count() or 1)
    out.extend(cross_row_issues(rows, cores))
    if not rows:
        out.append("no decomposition rows")
    return out


def find_prior(explicit: Optional[str], root: str = REPO):
    """``(path, artifact)`` of the newest of the port's own artifacts
    (``root/docs/scaling_port_r*.json``) that passes the consistency checks,
    or ``explicit``; None for ``"none"`` or when there is none."""
    if explicit == "none":
        return None
    if explicit:
        with open(explicit) as f:
            return explicit, json.load(f)
    cands = sorted(glob.glob(os.path.join(root, "docs", "scaling_port_r*.json")),
                   key=lambda p: int(re.search(r"_r(\d+)", p).group(1)), reverse=True)
    for p in cands:
        try:
            with open(p) as f:
                art = json.load(f)
        except (OSError, ValueError):
            continue
        iss = artifact_issues(art)
        if art.get("valid", True) and not iss:
            return p, art
        print(f"prior {os.path.basename(p)} rejected: {iss or ['valid=false']}",
              flush=True)
    return None


# ---------------------------------------------------------------------------
# one leg on each rank
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adaptive_time(mesh, fn: Callable[[], object], min_reps: int, max_reps: int,
                  tol: float):
    """Repeat ``fn`` until the best two repetitions agree within ``tol``
    (at least ``min_reps``, at most ``max_reps``); a repetition's time is
    the slowest rank's, so every rank stops together.  Returns the mean of
    the best two and every repetition's seconds."""
    import torch

    from incagg_gnn_tpu_torch.parallel import mesh as M

    times = []
    while True:
        _sync(mesh.device)
        t0 = time.perf_counter()
        fn()
        _sync(mesh.device)
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=mesh.device if mesh.backend == "nccl" else "cpu")
        times.append(float(M.all_gather(mesh, dt).max()))
        if len(times) >= min_reps:
            b = sorted(times)[:2]
            if (b[1] - b[0]) / max(b[0], 1e-9) <= tol:
                break
        if len(times) >= max_reps:
            break
    b = sorted(times)[:2]
    return (b[0] + b[1]) / 2, [round(t, 4) for t in times]


def leg_rank(mesh, prepared, arch: dict, trainer_kw: dict, wires, reps: tuple,
             a2a: bool = False) -> dict:
    """One leg on this rank: one ``ShardedVRTrainer`` (GCN ``arch``,
    parameters from ``trainer_kw``'s seed) and, for each wire of ``wires``
    in turn (``use_wire``), one refresh and one epoch to warm, then the
    timed epochs and refreshes (``reps``: min, max, tolerance); with
    ``a2a``, an all-to-all alone at the eval halo's buffer shape.  Returns
    each wire's seconds, this rank's halo payload rows, the all-to-alls and
    wire bytes of the wire's runs, and the peak device memory."""
    import torch

    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.parallel import mesh as M
    from incagg_gnn_tpu_torch.parallel.spatial import ShardedVRTrainer
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    dev, cuda = mesh.device, mesh.device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = GCN(GCNConfig(**arch), generator=torch.Generator().manual_seed(
        trainer_kw["seed"]))
    tr = ShardedVRTrainer(model, prepared.data,
                          TrainerConfig(**trainer_kw, halo_wire=wires[0]), mesh,
                          prepared=prepared)
    out = {"setup_s": time.perf_counter() - t0}
    for wire in wires:
        tr.use_wire(wire)
        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        tr.refresh(host_logits=False)
        tr.train_epoch()
        calls, wire_bytes = mesh.calls["all_to_all"], mesh.wire_bytes
        res = {"wire": tr.halo_wire}
        res["train_s"], res["train_all"] = adaptive_time(mesh, tr.train_epoch, *reps)
        res["refresh_s"], res["refresh_all"] = adaptive_time(
            mesh, lambda: tr.refresh(host_logits=False), *reps)
        res.update(
            all_to_all=mesh.calls["all_to_all"] - calls,
            wire_bytes=mesh.wire_bytes - wire_bytes,
            payload_rows=sum(ex.payload_rows() for ex in tr._eval_halos),
            halo_width=tr.plan.eval.halo_width, rounds=tr._eval_rounds,
            edges=int(prepared.data.adj_t.nnz),
            peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0)
        out[wire] = res
    if a2a:
        h, d = tr.plan.eval.halo_width, arch["hidden_channels"]
        buf = torch.ones((mesh.world * h, d), device=dev)
        M.all_to_all(mesh, buf)
        s, all_s = adaptive_time(mesh, lambda: M.all_to_all(mesh, buf), *reps)
        out["a2a"] = {"s": s, "all": all_s, "halo_width": h, "width": d}
    return out


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def card_label(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return "CPU"
    idx = torch.device(device).index or 0
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def make_row(nd: int, leg: dict) -> dict:
    full, loop = leg["full"], leg["loop"]
    return {
        "devices": nd,
        "backend": leg["backend"],
        "wire_full": full["wire"],
        "train_s_full": round(full["train_s"], 4),
        "train_s_loopback": round(loop["train_s"], 4),
        "refresh_s_full": round(full["refresh_s"], 4),
        "refresh_s_loopback": round(loop["refresh_s"], 4),
        "train_s_all_reps": full["train_all"],
        "refresh_s_all_reps": full["refresh_all"],
        "train_s_loopback_all_reps": loop["train_all"],
        "refresh_s_loopback_all_reps": loop["refresh_all"],
        "edges_per_s_full": round(full["edges"] / max(full["train_s"], 1e-9)),
        "setup_s": round(leg["setup_s"], 3),
        "all_to_all_per_refresh_and_epoch_loopback": loop["all_to_all"],
        "peak_bytes_rank0": {"full": full["peak_bytes"], "loopback": loop["peak_bytes"]},
        "loadavg_at_leg": leg["loadavg_at_leg"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m incagg_gnn_tpu_torch.scaling_bench")
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4],
                    help="rank counts of the one-dimensional legs")
    ap.add_argument("--device", default="cuda",
                    help="cuda:K: every rank on that card over gloo; cuda: rank r on "
                         "cuda:r over NCCL; cpu must be asked for")
    ap.add_argument("--num-nodes", type=int, default=200_000)
    ap.add_argument("--avg-degree", type=float, default=14.0)
    ap.add_argument("--num-parts", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0,
                    help="the graph, the partition and the parameters")
    ap.add_argument("--mode", choices=["gas", "vr"], default="gas",
                    help="gas = halo-heavy batch-parallel (the hard case); "
                         "vr = Reverb (one all-reduce a step)")
    ap.add_argument("--mesh2d", default="2x2",
                    help="'HxC' hosts-x-chips row on H*C ranks, or 'none'")
    ap.add_argument("--nccl-world1", action="store_true",
                    help="add one row over NCCL at world size 1 (CUDA only)")
    ap.add_argument("--link-gbps", type=float, default=NVLINK4_GBPS,
                    help="assumed link bandwidth for the halo projection, GB/s "
                         "(default: the NVLink 4 specification, not a measurement)")
    ap.add_argument("--prior", default=None,
                    help="prior artifact to guard against (default: the newest "
                         "consistent docs/scaling_port_r*.json; 'none' disables)")
    ap.add_argument("--max-start-load", type=float, default=0.8,
                    help="refuse to run when the one-minute load exceeds this")
    ap.add_argument("--min-reps", type=int, default=3)
    ap.add_argument("--max-reps", type=int, default=5)
    ap.add_argument("--agree-tol", type=float, default=0.06)
    ap.add_argument("--workdir", default=None,
                    help="directory of the spawned ranks' files (default: a temp dir)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.min_reps < 2 or args.max_reps < args.min_reps:
        ap.error("--min-reps must be at least 2 and at most --max-reps")

    load_start = os.getloadavg()
    if load_start[0] > args.max_start_load:
        print(json.dumps({"error": "host busy at start — refusing to measure",
                          "loadavg": load_start, "max_start_load": args.max_start_load}))
        sys.exit(3)

    import torch

    from incagg_gnn_tpu_torch.graph.datasets import make_sbm
    from incagg_gnn_tpu_torch.parallel import mesh as M
    from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks
    from incagg_gnn_tpu_torch.parallel.layout import (
        build_shard_layout_hierarchical, edge_locality)
    from incagg_gnn_tpu_torch.parallel.plan import choose_layout
    from incagg_gnn_tpu_torch.parallel.spatial import prepare_graph
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    card = card_label(dev)
    cores = os.cpu_count() or 1
    backend = M.default_backend(args.device) if dev.index is None else "gloo"
    data, in_c, out_c = make_sbm(num_nodes=args.num_nodes, num_classes=16,
                                 num_features=64, avg_degree=args.avg_degree,
                                 seed=args.seed)
    trainer_kw = dict(num_parts=args.num_parts, batch_size=1,
                      vr_update=args.mode == "vr", seed=args.seed, epochs=1)
    prepared = prepare_graph(data, TrainerConfig(**trainer_kw))
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=args.hidden,
                out_channels=out_c, num_layers=args.layers, dropout=0.1,
                drop_input=False)
    reps = (args.min_reps, args.max_reps, args.agree_tol)

    def run_leg(nd: int, label: str, backend=backend, n_hosts: int = 1, a2a=False):
        """One leg of ``nd`` ranks, the full wire then loopback: spawned,
        or in this process at one rank (a spawn costs more than that leg)."""
        devices = M.place_ranks(args.device, nd, backend)
        full = "dense" if backend == "gloo" or nd == 1 else "ragged"
        loads = os.getloadavg()
        leg_args = (prepared, arch, trainer_kw, (full, "loopback"), reps, a2a)
        if nd == 1:
            tmp = tempfile.mkdtemp(prefix="incagg_leg_")
            mesh = M.init_distributed(0, 1, f"file://{tmp}/rendezvous", backend, devices[0])
            try:
                res = [leg_rank(mesh, *leg_args)]
            finally:
                M.shutdown()
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            workdir = None if args.workdir is None else os.path.join(args.workdir, label)
            res = spawn_ranks(leg_rank, nd, devices, backend, args=leg_args,
                              n_hosts=n_hosts, workdir=workdir,
                              threads=max(1, cores // nd))
        leg = {"full": dict(res[0][full]), "loop": res[0]["loopback"],
               "setup_s": res[0]["setup_s"], "backend": backend,
               "loadavg_at_leg": list(loads), "label": label}
        leg["full"]["payload_rows"] = sum(r[full]["payload_rows"] for r in res)
        return leg, res[0].get("a2a")

    prior = find_prior(args.prior)
    prior_rows = {}
    if prior is not None:
        prior_rows = {r["devices"]: r for r in prior[1]["decomposition"]}
        print(f"prior guard: {os.path.basename(prior[0])}", flush=True)
    where = (f"ranks sharing one {card} over gloo (the host wire), not scaling"
             if dev.type == "cuda" and backend == "gloo"
             else f"one rank a GPU over NCCL ({card} each)" if dev.type == "cuda"
             else "CPU ranks over gloo")
    results = {"harness": "incagg_gnn_tpu_torch/scaling_bench.py",
               "platform": f"{where}; {cores} host CPUs",
               "device": args.device, "card": card, "torch": torch.__version__,
               "loadavg_at_start": list(load_start),
               "prior_artifact": prior[0] if prior else None,
               "graph": {"num_nodes": args.num_nodes, "avg_degree": args.avg_degree,
                         "edges": int(prepared.data.adj_t.nnz),
                         "num_parts": args.num_parts, "mode": args.mode,
                         "model": f"GCN {args.layers}x{args.hidden}", "seed": args.seed},
               "decomposition": [], "suspect_legs": [], "consistency_issues": []}
    a2a_leg = {}

    def measure(nd: int):
        """One leg with its guards: loopback <= full and the prior
        comparison (contamination only slows: the faster of two kept)."""
        big = nd == max(args.devices)
        leg, a2a = run_leg(nd, f"1d_nd{nd}", a2a=big)
        row = make_row(nd, leg)
        pr = prior_rows.get(nd)
        rerun = bool(row_issues(row)) or (
            pr is not None and _totals(row)[0] > 1.3 * _totals(pr)[0])
        if rerun:
            print(f"nd={nd}: per-leg guard tripped — re-running", flush=True)
            leg2, a2a2 = run_leg(nd, f"1d_nd{nd}_rerun", a2a=big)
            row2 = make_row(nd, leg2)
            if _totals(row2)[0] < _totals(row)[0]:
                row, leg, a2a = row2, leg2, a2a2
            if pr is not None and _totals(row)[0] > 1.3 * _totals(pr)[0]:
                results["suspect_legs"].append(
                    {"devices": nd, "total_s": round(_totals(row)[0], 3),
                     "prior_total_s": round(_totals(pr)[0], 3)})
        if big:
            a2a_leg.update(a2a=a2a, leg=leg)
        print(json.dumps(row), flush=True)
        return row, leg

    raw, legs = {}, {}
    for nd in args.devices:
        try:
            M.place_ranks(args.device, nd, backend)
        except RuntimeError as e:
            print(f"skip {nd} ranks: {e}", flush=True)
            continue
        raw[nd], legs[nd] = measure(nd)

    # a cross-row impossibility names the inflated leg: re-run exactly that
    # leg once, keep the faster, then check again
    for nd in sorted({f[0] for f in cross_row_flags(list(raw.values()), cores)}):
        print(f"cross-leg guard: nd={nd} capture implicated — re-running", flush=True)
        row2, leg2 = measure(nd)
        if _totals(row2)[0] < _totals(raw[nd])[0]:
            raw[nd], legs[nd] = row2, leg2
    for r in raw.values():
        results["consistency_issues"].extend(row_issues(r))
    results["consistency_issues"].extend(cross_row_issues(list(raw.values()), cores))

    # derived: the measured wire fraction, the sharding overhead against
    # one rank, and (the one-rank row has no wire, so its full - loopback
    # delta is the staging term both pay) the collective's corrected share
    t1_loop = None
    for nd in sorted(raw):
        row = raw[nd]
        full_t, loop_t = _totals(row)
        if t1_loop is None:
            t1_full, t1_loop = full_t, loop_t
        row["comm_fraction_measured"] = round(max(0.0, full_t - loop_t) / full_t, 4)
        row["sharding_overhead_vs_1dev"] = round(loop_t / t1_loop - 1.0, 4)
        row["raw_strong_efficiency"] = round(t1_full / (full_t * nd), 4)
        row["host_core_ceiling"] = min(nd, cores)
        results["decomposition"].append(row)
    rows = results["decomposition"]
    if rows and rows[0]["devices"] == 1:
        base = rows[0]["comm_fraction_measured"]
        for r in rows:
            r["collective_fraction_corrected"] = round(
                max(0.0, r["comm_fraction_measured"] - base), 4)

    if args.mesh2d != "none" and t1_loop is not None:
        h, c = (int(v) for v in args.mesh2d.split("x"))
        leg, _ = run_leg(h * c, f"2d_{h}x{c}", n_hosts=h)
        row = make_row(h * c, leg)
        if row_issues(row):  # one re-run, as the one-dimensional legs
            leg2, _ = run_leg(h * c, f"2d_{h}x{c}_rerun", n_hosts=h)
            row2 = make_row(h * c, leg2)
            if _totals(row2)[0] < _totals(row)[0]:
                row = row2
        full_t, loop_t = _totals(row)
        row["mesh"] = f"{h}x{c} (hosts x chips, host-major ranks)"
        row["comm_fraction_measured"] = round(max(0.0, full_t - loop_t) / full_t, 4)
        row["sharding_overhead_vs_1dev"] = round(loop_t / t1_loop - 1.0, 4)
        adj, ptr = prepared.data.adj_t, prepared.ptr
        hier = choose_layout(ptr, adj, h * c, h)
        flat = build_shard_layout_hierarchical(ptr, adj.rowptr, adj.col, h * c, 1)
        loc_h = edge_locality(hier, adj.rowptr, adj.col, ptr, chips_per_host=c)
        loc_f = edge_locality(flat, adj.rowptr, adj.col, ptr, chips_per_host=c)
        row["edge_locality_hierarchical"] = {k: round(float(v), 4) for k, v in loc_h.items()}
        row["edge_locality_flat_same_grouping"] = {k: round(float(v), 4)
                                                   for k, v in loc_f.items()}
        row["cross_host_halo_reduction"] = round(
            1.0 - float(loc_h["cross_host"]) / max(float(loc_f["cross_host"]), 1e-12), 4)
        results["consistency_issues"].extend(f"mesh2d: {m}" for m in row_issues(row))
        results["mesh2d"] = row
        print(json.dumps(row), flush=True)

    if args.nccl_world1:
        if dev.type != "cuda":
            ap.error("--nccl-world1 needs a CUDA device")
        leg, _ = run_leg(1, "nccl_world1", backend="nccl")
        row = make_row(1, leg)
        row["note"] = "NCCL at world size 1: no host wire; dense, as ragged moves no rows"
        results["consistency_issues"].extend(f"nccl_world1: {m}" for m in row_issues(row))
        results["nccl_world1"] = row
        print(json.dumps(row), flush=True)

    if a2a_leg:
        nd = max(raw)
        a2a, full = a2a_leg["a2a"], a2a_leg["leg"]["full"]
        h_w, d = a2a["halo_width"], a2a["width"]
        bytes_dense = nd * nd * h_w * d * 4
        gbps = bytes_dense / a2a["s"] / 1e9
        prior_a2a = prior[1].get("all_to_all_microbench") if prior else None
        if prior_a2a and gbps < 0.7 * prior_a2a.get("host_gbps", 0):
            results["consistency_issues"].append(
                f"a2a microbench {gbps:.2f} GB/s < 0.7x prior {prior_a2a['host_gbps']} "
                f"GB/s for the identical op — host contention suspected")
        results["all_to_all_microbench"] = {
            "devices": nd, "halo_width_h": h_w, "width": d,
            "buffer_bytes_total": bytes_dense, "ms": round(a2a["s"] * 1e3, 4),
            "host_gbps": round(gbps, 3), "reps_s": a2a["all"],
            "note": ("NCCL" if backend == "nccl" else "gloo over host memory" + (
                ", each CUDA buffer staged both ways" if dev.type == "cuda" else ""))}
        payload = full["payload_rows"]
        results["halo_bytes"] = {
            "payload_rows_per_sweep_layer": payload,
            "wire_rows_dense": nd * (nd - 1) * h_w * full["rounds"],
            "wire_rows_ragged": payload,
            "payload_mb_per_sweep_layer_f32": round(payload * d * 4 / 1e6, 3),
            "link_gbps_assumed": args.link_gbps, "link_note": LINK_NOTE,
            "link_ms_per_sweep_layer_at_assumed_bw": round(
                payload * d * 4 / nd / (args.link_gbps * 1e9) * 1e3, 4)}
    results["loadavg_at_end"] = list(os.getloadavg())
    results["valid"] = not results["consistency_issues"] and not results["suspect_legs"]
    print(json.dumps({k: results.get(k) for k in
                      ("all_to_all_microbench", "halo_bytes", "valid",
                       "consistency_issues", "suspect_legs")}, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
