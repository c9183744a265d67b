"""Device-time profile of the hybrid aggregation and of one train step, on
one CUDA GPU.

    python3 -m incagg_gnn_tpu_torch.profile_agg

Part 1 takes one ``spmm_bi`` forward and backward on the loader-built
``BiHybridAdj`` of one training batch (the first ``batch_size`` clusters,
collated with the loader's buckets): GCN's ``sbm-arxiv`` batch (80 parts,
40 clusters) at D256 and D40, GCNII's ``sbm-products-mid`` batch (30 parts,
1 cluster) at D128.  Each runs under ``torch.profiler``; the device time
of every kernel, and of the aten operations around the aggregation, is
printed, beside kernel B's launches per call (its counter) and a
CUDA-event time of the whole forward + backward and of its pieces (each
side's aggregation as the path calls it, the ELL core alone, the
overflow's torch operations alone).

Part 2 takes one train step of GCN arxiv hybrid GAS, one of GCNII
products hybrid GAS and one of GAT arxiv hybrid GAS (on ``sbm-arxiv``;
after a fill and warm-up steps) and prints the
device-busy share: the kernels' summed device time (user annotations
left out) over the host wall time of the step, which ends in a device
sync.  The host collate of the step's batch is timed beside it.

Every line names the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("aten::index_select", "aten::mul", "aten::index_add", "aten::index_add_",
       "aten::copy_", "aten::add", "aten::zeros", "aten::fill_")


def log(msg: str) -> None:
    print(msg, flush=True)


def events_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """CUDA-event time of one call after a short warm-up: ``reps`` calls
    back to back, the median over ``windows`` such runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile(fn, reps: int):
    """Run ``fn`` ``reps`` times under the profiler; returns the device
    kernels' time by name (us per call, calls per call), the listed aten
    operations' device time (us per call) and the summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = collections.defaultdict(lambda: [0.0, 0.0])
    for evt in prof.events():
        # a user annotation (e.g. the optimizer's range) spans kernels and gaps
        if evt.device_type == DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            k = kernels[evt.name]
            k[0] += evt.device_time_total / reps
            k[1] += 1 / reps
    ops = {evt.key: (evt.device_time_total / reps, evt.count / reps)
           for evt in prof.key_averages() if evt.key in OPS}
    total = sum(v[0] for v in kernels.values())
    return kernels, ops, total


def print_profile(tag: str, kernels, ops, total: float, card: str) -> None:
    log(f"  {tag}: device time {total:.1f} us per call ({card})")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        log(f"    kernel {us:9.1f} us  x{n:.1f}  {name[:110]}")
    for name, (us, n) in sorted(ops.items()):
        log(f"    op     {us:9.1f} us  x{n:.1f}  {name}")
    if total == 0.0:
        log("    the profiler saw no device time: see the CUDA-event times")


def loader_batch(yaml_name: str, dataset: str, device):
    """The training loader's first batch (clusters 0..batch_size-1) of the
    configuration, hybrid format, on ``device``, and its trainer config."""
    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import SubgraphLoader
    from incagg_gnn_tpu_torch.train.config import load_config

    cfg = load_config(os.path.join(ROOT, "conf", "model", yaml_name), dataset,
                      {"adj_format": "hybrid"}).trainer
    data, _, _ = get_data("", dataset)
    perm, ptr = partition_graph(data.adj_t, cfg.num_parts, seed=cfg.seed)
    data = permute(data, perm)
    data.adj_t = gcn_norm(data.adj_t.set_diag(), add_self_loops=False)
    loader = SubgraphLoader(data, ptr, device, batch_size=cfg.batch_size,
                            mode="gas", shuffle=True, seed=cfg.seed,
                            adj_format="hybrid")
    hb = loader._collate(loader._groups(shuffled=False)[0])
    b = loader.buckets
    log(f"  {dataset}: batch of {cfg.batch_size} clusters, R_pad {b.rows} "
        f"C_pad {b.cols}, K {b.k} ovf {b.ovf}, K_t {b.k_t} ovf_t {b.ovf_t}")
    return hb.device.adj.to(device)


def describe(tag: str, adj) -> None:
    """Real and padding slots of a hybrid table, its overflow and levels."""
    real = int((adj.ell_vals != 0).sum())
    slots = adj.ell_vals.numel()
    o_real = int((adj.ovf_vals != 0).sum())
    log(f"    {tag}: ELL {tuple(adj.ell_cols.shape)} real {real} "
        f"({100 * (1 - real / max(slots, 1)):.1f}% padding); overflow "
        f"{adj.ovf_rows.numel()} entries, {o_real} real; ext levels "
        f"{len(adj.ext)}; incidence {'yes' if adj.ovf_inc is not None else 'no'}")


def part_aggregation(device, card: str) -> None:
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.ops.ell import spmm_bi, spmm_hybrid

    cases = [("gcn.yaml", "sbm-arxiv", (256, 40)),
             ("gcn2.yaml", "sbm-products-mid", (128,))]
    gen = torch.Generator(device=device).manual_seed(0)
    for yaml_name, dataset, widths in cases:
        adj = loader_batch(yaml_name, dataset, device)
        describe("forward", adj.fwd)
        describe("transpose", adj.bwd)
        for d in widths:
            x = torch.randn(adj.bwd.num_rows, d, generator=gen,
                            device=device).requires_grad_()
            g = torch.randn(adj.fwd.num_rows, d, generator=gen, device=device)

            def fwd_bwd():
                out = spmm_bi(adj, x)
                out.backward(g)
                x.grad = None

            tag = f"{dataset} D{d} spmm_bi forward+backward"
            kernels, ops, total = profile(fwd_bwd, reps=5)
            print_profile(tag, kernels, ops, total, card)
            before = K.ell_spmm.launches
            fwd_bwd()
            log(f"    kernel B launches per forward+backward: "
                f"{K.ell_spmm.launches - before}")
            xd = x.detach()
            pieces = {"forward+backward": fwd_bwd}
            for side, h, v in (("fwd", adj.fwd, xd), ("bwd", adj.bwd, g)):
                pieces[f"{side} aggregation (spmm_hybrid)"] = (
                    lambda h=h, v=v: spmm_hybrid(h, v))
                pieces[f"{side} ELL core (ell_spmm)"] = (
                    lambda h=h, v=v: K.ell_spmm(h.ell_cols, h.ell_vals, v))
                core = K.ell_spmm(h.ell_cols, h.ell_vals, v)

                def ovf(h=h, v=v, core=core):
                    go = v.index_select(0, h.ovf_cols) * h.ovf_vals[:, None]
                    return core.index_add(0, h.ovf_rows, go)

                pieces[f"{side} overflow (index_select, mul, index_add)"] = ovf
            for name, fn in pieces.items():
                log(f"    events {name}: {events_ms(fn):.4f} ms ({card})")
            del x, g
        del adj
        torch.cuda.empty_cache()


def part_train_step(device, card: str) -> None:
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import load_config
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    for yaml_name, block, dataset in (("gcn.yaml", "sbm-arxiv", "sbm-arxiv"),
                                      ("gcn2.yaml", "sbm-products-mid", "sbm-products-mid"),
                                      ("gat.yaml", "arxiv", "sbm-arxiv")):
        run_cfg = load_config(os.path.join(ROOT, "conf", "model", yaml_name), block,
                              {"adj_format": "hybrid", "epochs": 1, "dataset": dataset})
        data, in_c, out_c = get_data("", dataset)
        model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
        trainer = Trainer(model, data, run_cfg.trainer, device)
        trainer.fill_history()
        for i, hb in enumerate(trainer.train_loader):  # warm-up steps
            trainer.step(hb.wait())
            if i >= 2:
                break
        torch.cuda.synchronize()
        it = iter(trainer.train_loader)
        t = time.perf_counter()
        hb = next(it).wait()
        collate_s = time.perf_counter() - t

        def step():
            trainer.step(hb)
            torch.cuda.synchronize()

        walls = []
        for _ in range(10):
            t = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t)
        kernels, ops, total = profile(step, reps=3)
        wall_us = statistics.median(walls) * 1e6
        tag = f"{yaml_name} {dataset} hybrid GAS train step"
        print_profile(tag, kernels, ops, total, card)
        log(f"    {tag}: wall {wall_us:.1f} us (median of {len(walls)}, unprofiled), "
            f"device busy {total:.1f} us = {total / wall_us:.3f} of the step; "
            f"next-batch collate + staging {collate_s:.4f} s ({card})")
        del trainer, model, it, hb
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m incagg_gnn_tpu_torch.profile_agg")
    ap.add_argument("--part", choices=("all", "agg", "step"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_agg: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    log(card)
    from incagg_gnn_tpu_torch.ops.kernels import build_kernels

    log(f"kernels built in {build_kernels():.2f} s")
    if args.part in ("all", "agg"):
        log("part 1: spmm_bi forward + backward on loader-built batches")
        part_aggregation(device, card)
    if args.part in ("all", "step"):
        log("part 2: one hybrid GAS train step")
        part_train_step(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
