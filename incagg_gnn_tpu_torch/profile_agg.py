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
products hybrid GAS, one of GAT arxiv hybrid GAS and one of PNA arxiv
hybrid GAS (on ``sbm-arxiv``; after a fill and warm-up steps) and prints
the device-busy share: the kernels' summed device time (user annotations
left out) over the host wall time of the step, which ends in a device
sync, and for PNA the share of kernel B's max form in the device time.
The host collate of the step's batch is timed beside it.

Part 3 (``--part max``) takes kernel B's max form on PNA's arxiv path:
one 40-cluster ``sbm-arxiv`` training batch (the hybrid pair, binarized)
and one single-cluster eval batch as the eval loader collates it, x
relu'd normals with the min half negated (as ``chip_smoke.py`` phase 2
builds them).  It times, by CUDA events, one launch at D768 and D240
against the launches over contiguous 32-, 64- and 128-column slices of
the same operands (forward with and without ties, backward), the
backward's kernels by name under ``torch.profiler``, and the backward on
the transpose with its tail emptied; on the eval batch, the forward the
same way.  With
``--parent-src FILE`` (another version of ``csrc/ell_max.cu`` with the
same C interface) it builds that file into its own library
and times it against the current kernels in turns (parent, change,
change, parent), checking the forward's ``out`` and ``ties`` and the
backward's ``dx`` bit for bit against it.

Part 4 (``--part ceiling``) times the max form's forward, kernel B's sum
and the max form's backward on the same PNA arxiv tables at D768 with
every column folded onto an x of 166k, 4,096 and 8 rows: the same gathers
from HBM and L2, from L2 alone, and from L1.

Part 5 (``--part replays``) profiles fused GCNII products hybrid GAS
epochs (CUDA-graph replays) after six earlier profiler sessions, eight
as they are and four with device sleep around the epoch, and compares
kernel B's launches by the counters with the profiler's events and raw
records, replay by replay.

Part 6 (``--part heads``) takes kernel B's heads form on GAT arxiv's
tables (the 40-cluster forward table and its transpose, each with its
tail, and the first single-cluster eval table; four heads of 64): the
heads form, kernel B on the same gathers with one value a slot, and the
heads form with equal values across heads, by CUDA events and as
CUDA-graph replays, with the compiler's registers and spills for the
heads form's kernels.  Part 7 (``--part table``) takes kernel B's
storage-dtype form on the first global-column eval batch of GCN arxiv
and GCNII products, the cache table in f32, bf16, e4m3 and e5m2, the
kernel beside its bound and the wrapper's host time without a launch.
With ``--parent-src FILE`` (another ``csrc/ell_spmm.cu`` with the same C
interface) each times that build against
the current kernels in turns, by events and by replays: the heads form
equal bit for bit, the storage-dtype form within 1e-5 of its largest
value.

Part 8 (``--part refresh``) takes the refresh sweep of GCN arxiv hybrid
GAS (global columns), GCN arxiv block VR, GCNII products hybrid VR (global
columns) and GAT arxiv hybrid VR (the heads form), each on its filled
state: the eval set's one-time collate and staging; the eager sweep
(``refresh(scan=False)``) by its wall seconds (median of 5, each ending in
a device sync), the host seconds spent inside the kernel wrappers, its
launches, and its device time by kernel name under ``torch.profiler``;
then the captured sweep (``scan=True``: the capture's seconds, the median
of 5 replays, its device time); peak device memory each way.

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


def graph_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """Device time of one call without the host's launch cost: ``reps``
    calls captured as one CUDA graph, its replays timed by CUDA events
    (median of ``windows``).  For launches of a few microseconds, where
    back-to-back calls measure the host's enqueue, not the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def host_us(fn, reps: int = 2000) -> float:
    """Host time of one call (perf_counter over ``reps`` calls), for calls
    that launch nothing."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e6


def turns(runs: dict) -> str:
    """The contenders ``runs`` (name: call) in turns, forward then backward
    through the list (parent, change, change, parent for two), each by
    CUDA events back to back and as CUDA-graph replays."""
    times = collections.defaultdict(list)
    for who in list(runs) + list(runs)[::-1]:
        times[who].append((events_ms(runs[who]), graph_ms(runs[who])))
    return "; ".join(f"{who} events {t[0][0]:.4f} / {t[1][0]:.4f}, replays {t[0][1]:.4f} / "
                     f"{t[1][1]:.4f} ms" for who, t in times.items())


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
                                      ("gat.yaml", "arxiv", "sbm-arxiv"),
                                      ("pna.yaml", "arxiv", "sbm-arxiv")):
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
        mx = sum(us for name, (us, _) in kernels.items()
                 if "hybrid_max" in name or "max_bwd_" in name)
        if mx:
            log(f"    {tag}: kernel B's max form (forward, backward and its h pass) "
                f"{mx:.1f} us = {mx / total:.3f} of the device time ({card})")
        del trainer, model, it, hb
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# part 3: kernel B's max form
# ---------------------------------------------------------------------------

def pna_batches(device):
    """PNA arxiv's 40-cluster training pair and its first single-cluster
    eval table, binarized as PNA aggregates them, built as the trainer
    builds them (80 parts, seed 42; no self loops, no normalization)."""
    from incagg_gnn_tpu_torch.graph.csr import permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader

    data, _, _ = get_data("", "sbm-arxiv")
    perm, ptr = partition_graph(data.adj_t, 80, seed=42)
    data = permute(data, perm)
    loader = SubgraphLoader(data, ptr, "cpu", batch_size=40, mode="gas", shuffle=True,
                            seed=42, adj_format="hybrid")
    pair = loader._collate(loader._groups(shuffled=False)[0]).device.adj
    ev = EvalSubgraphLoader(data, ptr, "cpu", batch_size=1, adj_format="hybrid-fwd")
    ev_adj = ev.cached()[0].wait().device.adj
    return pair.to(device).binarized(), ev_adj.to(device).binarized()


def x_cols(h) -> int:
    """The x rows a hybrid table names: its trash column is the last."""
    return int(max(int(h.ell_cols.max()), int(h.ovf_cols.max()))) + 1


def pna_x(rows: int, d: int, gen, device) -> torch.Tensor:
    """Relu'd normals, the min half negated (six stacked branches, as
    ``PNAConv.pre`` passes them): ties are common."""
    x = torch.randn(rows, d, generator=gen, device=device).relu_()
    x[1::7] = x[0]
    x[:, d // 2:] = -x[:, d // 2:]
    return x


def slices(t: torch.Tensor, w: int) -> list:
    return [t[:, j:j + w].contiguous() for j in range(0, t.shape[1], w)]


def parent_lib(src: str, bind=None):
    """Build ``src`` (another version of a ``csrc/`` source with the same C
    interface) into ``build/parent_<name>.so`` and bind it with ``bind``
    (default: ``ell_max.cu``'s interface), printing its ``ell_spmm``
    kernels' registers and spills."""
    import ctypes

    from incagg_gnn_tpu_torch.ops.kernels import _nvcc, bind_max_form

    name = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(ROOT, "build", f"parent_{name}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", so, src]
    proc = subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    print_ptxas(f"parent {os.path.basename(src)}", proc.stdout + proc.stderr)
    return (bind or bind_max_form)(ctypes.CDLL(so))


def print_ptxas(tag: str, report: str, pattern: str = "ell_spmm") -> None:
    """The ``-Xptxas -v`` lines (registers, stack, spills) of every kernel
    whose mangled name holds ``pattern``."""
    entry = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and pattern in entry and ("registers" in line or "spill" in line):
            log(f"    ptxas {tag}: {entry[:90]}: {line.split(':', 1)[-1].strip()}")


def parent_fwd(lib, h, x, want_ties: bool):
    r, k = h.ell_cols.shape
    out = torch.empty((r, x.shape[1]), device=x.device)
    ties = torch.empty_like(out) if want_ties else None
    rc = lib.hybrid_max_f32(h.ell_cols.data_ptr(), h.ell_vals.data_ptr(),
                            h.ovf_ptr.data_ptr(), h.ovf_cols.data_ptr(),
                            h.ovf_vals.data_ptr(), h.deg.data_ptr(), x.data_ptr(),
                            out.data_ptr(), ties.data_ptr() if want_ties else None,
                            r, k, x.shape[1], torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent hybrid_max_f32: CUDA error {rc}"
    return out, ties


def parent_bwd(lib, b, g, ties, out, x, deg_fwd):
    c, k = b.ell_cols.shape
    h = torch.empty_like(g)
    dx = torch.empty_like(x)
    rc = lib.hybrid_max_bwd_f32(b.ell_cols.data_ptr(), b.ell_vals.data_ptr(),
                                b.ovf_ptr.data_ptr(), b.ovf_cols.data_ptr(),
                                b.ovf_vals.data_ptr(), g.data_ptr(), ties.data_ptr(),
                                out.data_ptr(), deg_fwd.data_ptr(), x.data_ptr(),
                                h.data_ptr(), dx.data_ptr(), c, k, x.shape[1],
                                g.shape[0], torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"parent hybrid_max_bwd_f32: CUDA error {rc}"
    return dx


def part_max(device, card: str, parent_src=None) -> None:
    from incagg_gnn_tpu_torch.ops import kernels as K

    pair, ev = pna_batches(device)
    f, b = pair.fwd, pair.bwd
    ft = (f.ell_cols, f.ell_vals, f.ovf_ptr, f.ovf_cols, f.ovf_vals)
    bt = (b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals)
    et = (ev.ell_cols, ev.ell_vals, ev.ovf_ptr, ev.ovf_cols, ev.ovf_vals)
    c_train, c_eval = b.num_rows, x_cols(ev)
    log(f"  PNA train pair: forward {tuple(f.ell_cols.shape)} +{int(f.ovf_ptr[-1])} tail, "
        f"transpose {tuple(b.ell_cols.shape)} +{int(b.ovf_ptr[-1])} tail; eval table "
        f"{tuple(ev.ell_cols.shape)} +{int(ev.ovf_ptr[-1])} tail over {c_eval} x rows "
        f"({card})")
    gen = torch.Generator(device=device).manual_seed(3)
    no_tail = (b.ell_cols, b.ell_vals, torch.zeros_like(b.ovf_ptr), b.ovf_cols, b.ovf_vals)
    ops = {}
    for d in (768, 240):
        x = pna_x(c_train, d, gen, device)
        out, ties = K.hybrid_max(*ft, f.deg, x, want_ties=True)
        g = torch.randn(f.num_rows, d, generator=gen, device=device)
        xe = pna_x(c_eval, d, gen, device)
        ops[d] = (x, out, ties, g, xe)
        # step 0: one launch against launches over contiguous column slices
        for w in (32, 64, 128):
            xs, os_, ts, gs = (slices(t, w) for t in (x, out, ties, g))
            got = torch.cat([K.hybrid_max(*ft, f.deg, s, want_ties=True)[1] for s in xs], 1)
            assert torch.equal(got, ties), "sliced ties differ"
            for want_ties in (False, True):
                one = events_ms(lambda: K.hybrid_max(*ft, f.deg, x, want_ties=want_ties))
                many = events_ms(lambda: [K.hybrid_max(*ft, f.deg, s, want_ties=want_ties)
                                          for s in xs])
                log(f"    fwd D{d} ties={want_ties}: one launch {one:.4f} ms, "
                    f"{len(xs)} launches over {w}-column slices {many:.4f} ms ({card})")
            one = events_ms(lambda: K.hybrid_max_bwd(*bt, g, ties, out, x, f.deg))
            many = events_ms(lambda: [K.hybrid_max_bwd(*bt, a, t, o, s, f.deg)
                                      for a, t, o, s in zip(gs, ts, os_, xs)])
            log(f"    bwd D{d}: one launch {one:.4f} ms, {len(xs)} launches over "
                f"{w}-column slices {many:.4f} ms ({card})")
            xes = slices(xe, w)
            one = events_ms(lambda: K.hybrid_max(*et, ev.deg, xe))
            many = events_ms(lambda: [K.hybrid_max(*et, ev.deg, s) for s in xes])
            log(f"    eval fwd D{d}: one launch {one:.4f} ms, {len(xes)} launches over "
                f"{w}-column slices {many:.4f} ms ({card})")
            del xs, os_, ts, gs, xes
        kernels, _, total = profile(lambda: K.hybrid_max_bwd(*bt, g, ties, out, x, f.deg), 5)
        print_profile(f"bwd D{d} kernels by name", kernels, {}, total, card)
        log(f"    bwd D{d}, transpose tail emptied: "
            f"{events_ms(lambda: K.hybrid_max_bwd(*no_tail, g, ties, out, x, f.deg)):.4f} ms "
            f"({card})")
    if parent_src is None:
        return
    lib = parent_lib(parent_src)

    def device_us(fn) -> float:
        return profile(fn, 20)[2]

    for d, (x, out, ties, g, xe) in ops.items():
        cases = {}
        for want_ties in (False, True):
            a = parent_fwd(lib, f, x, want_ties)
            z = K.hybrid_max(*ft, f.deg, x, want_ties=want_ties)
            assert torch.equal(a[0], z[0]) and (not want_ties or torch.equal(a[1], z[1])), \
                f"D{d}: forward differs from the parent's"
            cases[f"fwd ties={want_ties}"] = (
                lambda w=want_ties: parent_fwd(lib, f, x, w),
                lambda w=want_ties: K.hybrid_max(*ft, f.deg, x, want_ties=w))
        assert torch.equal(parent_bwd(lib, b, g, ties, out, x, f.deg),
                           K.hybrid_max_bwd(*bt, g, ties, out, x, f.deg)), \
            f"D{d}: backward dx differs from the parent's"
        cases["bwd"] = (lambda: parent_bwd(lib, b, g, ties, out, x, f.deg),
                        lambda: K.hybrid_max_bwd(*bt, g, ties, out, x, f.deg))
        assert torch.equal(parent_fwd(lib, ev, xe, False)[0], K.hybrid_max(*et, ev.deg, xe)[0])
        cases["eval fwd"] = (lambda: parent_fwd(lib, ev, xe, False),
                             lambda: K.hybrid_max(*et, ev.deg, xe))
        for name, (par, chg) in cases.items():
            t = [events_ms(fn) for fn in (par, chg, chg, par)]
            us = [device_us(fn) for fn in (par, chg, chg, par)]
            log(f"    A/B D{d} {name}: CUDA events parent {t[0]:.4f}, change {t[1]:.4f}, "
                f"change {t[2]:.4f}, parent {t[3]:.4f} ms; profiler device time parent "
                f"{us[0]:.1f}, change {us[1]:.1f}, change {us[2]:.1f}, parent {us[3]:.1f} us; "
                f"bit for bit equal ({card})")


def fold(h, n: int) -> tuple:
    """A hybrid table's five tensors with every column folded onto the
    first ``n`` x rows (``col % n``): the same slots, rows and tail, so the
    same gathers and instructions, over an x of ``n`` rows."""
    return (h.ell_cols % n, h.ell_vals, h.ovf_ptr, h.ovf_cols % n, h.ovf_vals)


def part_ceiling(device, card: str) -> None:
    """What bounds the max form's gathers: the forward without ties, kernel
    B's sum and the max form's backward on PNA's arxiv tables at D768, with
    every column folded onto an x of 166k rows (as trained: more than the
    L2 holds), 4,096 rows (12.6 MB, L2-resident) and 8 rows (24 KB, in
    each SM's L1).  The gathered bytes are the real slots' rows; their rate
    at each size tells the HBM's share, the L2's and the per-slot
    instructions' apart."""
    from incagg_gnn_tpu_torch.ops import kernels as K

    pair, _ = pna_batches(device)
    f, b = pair.fwd, pair.bwd
    d = 768
    gen = torch.Generator(device=device).manual_seed(5)
    real_f = int((f.ell_vals != 0).sum()) + int((f.ovf_vals[:int(f.ovf_ptr[-1])] != 0).sum())
    real_b = int((b.ell_vals != 0).sum()) + int((b.ovf_vals[:int(b.ovf_ptr[-1])] != 0).sum())
    x_full = pna_x(b.num_rows, d, gen, device)
    out, ties = K.hybrid_max(*fold(f, b.num_rows), f.deg, x_full, want_ties=True)
    g = torch.randn(f.num_rows, d, generator=gen, device=device)
    log(f"  PNA forward {tuple(f.ell_cols.shape)}, {real_f} real slots; transpose "
        f"{tuple(b.ell_cols.shape)}, {real_b} real slots; D{d} ({card})")
    for n in (b.num_rows, 4096, 8):
        ft, bt = fold(f, n), fold(b, f.num_rows if n == b.num_rows else n)
        x = x_full[:n].contiguous()
        cases = {"max fwd": (lambda: K.hybrid_max(*ft, f.deg, x), real_f * d * 4),
                 "B sum fwd": (lambda: K.hybrid_spmm(*ft, x), real_f * d * 4),
                 # two rows (h and out) a slot; the h pass over all forward
                 # rows is in the time, not in the bytes
                 "max bwd": (lambda: K.hybrid_max_bwd(*bt, g, ties, out, x_full, f.deg),
                             2 * real_b * d * 4)}
        for name, (fn, gathered) in cases.items():
            ms = events_ms(fn)
            rows = n if name != "max bwd" or n != b.num_rows else f.num_rows
            mb = rows * d * 4 * (2 if name == "max bwd" else 1) / 1e6
            log(f"    {name} over {rows} gathered rows ({mb:.1f} MB): "
                f"{ms:.4f} ms, {gathered / 1e9:.3f} GB gathered at "
                f"{gathered / ms / 1e9:.2f} TB/s ({card})")
        del x


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.split("::")[-1].replace("void ", "").strip()


def part_replays(device, card: str, sessions: int = 6, plain: int = 8,
                 padded: int = 4) -> None:
    """Whether ``torch.profiler`` sees every kernel of a fused epoch's CUDA
    graph replays (``chip_smoke.py`` phase 7 e): GCNII products hybrid GAS,
    after ``sessions`` earlier profiler sessions, ``plain`` profiled fused
    epochs and ``padded`` more with 10 ms of device sleep before and after
    the epoch inside the window.  For each: kernel B's launches by the
    counters, in the profiler's events and in its raw records; the raw
    records binned by replay through the correlation id of their
    ``cudaGraphLaunch``; any replay whose kernels differ from the others'
    is printed with the difference and its place in the epoch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.train.config import load_config
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    run_cfg = load_config(os.path.join(ROOT, "conf", "model", "gcn2.yaml"),
                          "sbm-products-mid", {"adj_format": "hybrid"})
    data, in_c, out_c = get_data("", run_cfg.dataset)
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    tr = Trainer(model, data, run_cfg.trainer, device)
    tr.cfg.fused_epoch = "auto"
    tr.fill_history()
    for _ in range(2):  # the capture, then an epoch of replays
        r = tr.train_epoch()
    if not r["fused"]:
        raise RuntimeError(f"the epoch did not fuse: {r['reason']}")
    a = torch.randn(2048, 2048, device=device)
    for _ in range(sessions):
        profile(lambda: a @ a, 5)
    pats = ("ell_spmm_vec_kernel", "ell_spmm_scalar_kernel")
    for i in range(plain + padded):
        pad = i >= plain
        before = K.ell_spmm.launches
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if pad:
                torch.cuda._sleep(20_000_000)
            r = tr.train_epoch()
            if pad:
                torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        counted = K.ell_spmm.launches - before
        seen = sum(e.device_type == DeviceType.CUDA and any(p in e.name for p in pats)
                   for e in prof.events())
        raw = prof.profiler.kineto_results.events()
        launches = [e.correlation_id() for e in raw if e.name() == "cudaGraphLaunch"]
        dev = [e for e in raw if e.device_type() == DeviceType.CUDA]
        link = next((key for key in ("correlation_id", "linked_correlation_id")
                     if any(getattr(e, key)() in set(launches) for e in dev)),
                    "correlation_id")
        by_corr = collections.defaultdict(collections.Counter)
        for e in dev:
            by_corr[getattr(e, link)()][short_name(e.name())] += 1
        raw_b = sum(n for c in by_corr.values() for k, n in c.items() if k in pats)
        per = [by_corr.get(c, collections.Counter()) for c in launches]
        mode = collections.Counter(tuple(sorted(c.items())) for c in per).most_common(1)
        mode = dict(mode[0][0]) if mode else {}
        odd = [(j, {k: n - mode.get(k, 0) for k, n in (collections.Counter(mode) | c).items()
                    if c.get(k, 0) != mode.get(k, 0)}) for j, c in enumerate(per)
               if dict(c) != mode]
        log(f"    epoch {i} ({'padded' if pad else 'plain'}, fused {r['fused']}): "
            f"{len(launches)} graph launches; kernel B counted {counted}, profiler events "
            f"{seen}, raw records {raw_b}; kernels a replay {sum(mode.values())}; "
            f"replays that differ (index: kernels more or fewer) {odd}; device records "
            f"no replay owns {len(dev) - sum(sum(c.values()) for c in per)} ({card})")
    del tr, model


# ---------------------------------------------------------------------------
# parts 6 and 7: kernel B's heads form and storage-dtype form
# ---------------------------------------------------------------------------

def gat_tables(device, heads: int = 4, p_drop: float = 0.5) -> list:
    """GAT arxiv's tables as ``chip_smoke.py::gat_cases`` builds them: the
    40-cluster training pair (forward, and the transpose with the values
    moved through ``t2f``), the attention values of random scores with
    attention dropout ``p_drop``, and the eval loader's first
    single-cluster table without dropout.  ``(name, table, ve, vo, x
    rows)`` each."""
    from incagg_gnn_tpu_torch.graph.csr import permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
    from incagg_gnn_tpu_torch.models.gat import _to_bwd_layout, hybrid_att_coeffs

    data, _, _ = get_data("", "sbm-arxiv")
    perm, ptr = partition_graph(data.adj_t, 80, seed=42)
    data = permute(data, perm)
    loader = SubgraphLoader(data, ptr, "cpu", batch_size=40, mode="gas", shuffle=True,
                            seed=42, adj_format="hybrid", adj_perm=True)
    pair = loader._collate(loader._groups(shuffled=False)[0]).device.adj.to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    r_pad, c_pad = pair.fwd.num_rows, pair.bwd.num_rows
    att_e, att_o, *_ = hybrid_att_coeffs(
        pair.fwd, torch.randn(c_pad, heads, generator=gen, device=device),
        torch.randn(r_pad, heads, generator=gen, device=device))
    keep = 1.0 - p_drop
    att_e = att_e * (torch.rand(att_e.shape, generator=gen, device=device) < keep) / keep
    att_o = att_o * (torch.rand(att_o.shape, generator=gen, device=device) < keep) / keep
    ab_e, ab_o = _to_bwd_layout(pair.bwd, pair.t2f,
                                torch.cat([att_e.reshape(-1, heads), att_o]))
    ev = EvalSubgraphLoader(data, ptr, "cpu", batch_size=1, adj_format="hybrid-fwd")
    h = ev.cached()[0].wait().device.adj.to(device)
    x_rows = x_cols(h)
    ev_e, ev_o, *_ = hybrid_att_coeffs(
        h, torch.randn(x_rows, heads, generator=gen, device=device),
        torch.randn(h.num_rows, heads, generator=gen, device=device))
    return [("forward", pair.fwd, att_e.contiguous(), att_o.contiguous(), c_pad),
            ("transpose", pair.bwd, ab_e.contiguous(), ab_o.contiguous(), r_pad),
            ("eval batch 0", h, ev_e.contiguous(), ev_o.contiguous(), x_rows)]


def tail_stats(h) -> str:
    """A table's real slots, and its tail's rows and longest row."""
    n = int(h.ovf_ptr[-1])
    lens = h.ovf_ptr.diff()
    return (f"{int((h.ell_vals != 0).sum())} real ELL slots, tail {n} entries on "
            f"{int((lens > 0).sum())} rows, longest {int(lens.max())}")


def part_heads(device, card: str, parent_src=None, dh: int = 64) -> None:
    """Kernel B's heads form on GAT arxiv's tables at four heads of ``dh``:
    (i) the heads form; (ii) kernel B on the same table and x with one
    value a slot (the heads' largest |value|, so the same slots are
    taken): the same gathers without per-head values; (iii) the heads form
    with every slot's values equal across heads.  Each by CUDA events
    back to back and as CUDA-graph replays.  With ``parent_src`` (another
    ``csrc/ell_spmm.cu``), the heads form against that build in turns, its
    ``out`` required equal bit for bit."""
    from incagg_gnn_tpu_torch.ops import kernels as K

    with open(os.path.join(ROOT, "build", "kernels_build.log")) as f:
        print_ptxas("this tree", f.read(), "ell_spmm_heads")
    lib = parent_lib(parent_src, K.bind_spmm) if parent_src else None
    gen = torch.Generator(device=device).manual_seed(6)
    for name, h, ve, vo, x_rows in gat_tables(device):
        heads = int(ve.shape[-1])
        r, k = h.ell_cols.shape
        log(f"  GAT arxiv {name}: {r}x{k}x{heads} +{int(h.ovf_ptr[-1])} tail, H{heads} "
            f"Dh{dh}, x {x_rows} rows; {tail_stats(h)} ({card})")
        x = torch.randn(x_rows, heads * dh, generator=gen, device=device)
        one_e, one_o = ve.abs().amax(-1).contiguous(), vo.abs().amax(-1).contiguous()
        eq_e = one_e[..., None].expand_as(ve).contiguous()
        eq_o = one_o[:, None].expand_as(vo).contiguous()
        tab = (h.ell_cols, h.ovf_ptr, h.ovf_cols)

        def heads_fn(e, o):
            return lambda: K.hybrid_spmm_heads(tab[0], e, tab[1], tab[2], o, x)

        got = heads_fn(ve, vo)()
        want = K.hybrid_spmm_heads_reference(tab[0], ve, tab[1], tab[2], vo, x)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), f"{name}: heads form err {err}"
        same = torch.equal(heads_fn(eq_e, eq_o)(),
                           K.hybrid_spmm(tab[0], one_e, tab[1], tab[2], one_o, x))
        cases = {"(i) heads form": heads_fn(ve, vo),
                 "(ii) kernel B, one value a slot": (
                     lambda: K.hybrid_spmm(tab[0], one_e, tab[1], tab[2], one_o, x)),
                 "(iii) heads form, values equal across heads": heads_fn(eq_e, eq_o)}
        for case, fn in cases.items():
            log(f"    {case}: CUDA events {events_ms(fn):.4f} ms, graph replays "
                f"{graph_ms(fn):.4f} ms ({card})")
        log(f"    err (i) {err:.2e}; (iii) equal to (ii) bit for bit: {same}")
        if lib is None:
            continue

        def parent():
            out = torch.empty_like(got)
            rc = lib.ell_spmm_heads_f32(tab[0].data_ptr(), ve.data_ptr(), tab[1].data_ptr(),
                                        tab[2].data_ptr(), vo.data_ptr(), x.data_ptr(),
                                        out.data_ptr(), r, k, heads, dh,
                                        torch.cuda.current_stream().cuda_stream)
            assert rc == 0, f"parent ell_spmm_heads_f32: CUDA error {rc}"
            return out

        assert torch.equal(parent(), got), f"{name}: heads form differs from the parent's"
        log(f"    turns, heads form ({card}): "
            f"{turns({'parent': parent, 'change': cases['(i) heads form']})}; bit for bit equal")


def refresh_table(yaml_name: str, block: str, device):
    """The first global-column eval batch of ``yaml_name``'s hybrid GAS
    trainer on ``block`` (its hybrid table, columns naming rows of the
    ``[N+1, D]`` cache tables) and the cache table's shape."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import load_config
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    run_cfg = load_config(os.path.join(ROOT, "conf", "model", yaml_name), block,
                          {"adj_format": "hybrid"})
    data, in_c, out_c = get_data("", run_cfg.dataset)
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    tr = Trainer(model, data, run_cfg.trainer, device)
    ev = tr.eval_loader
    h = ev.to_device(ev.cached()[0]).wait().device.adj
    if not ev.uses_global_cols:
        raise RuntimeError(f"{yaml_name} {block}: the eval batches are not global-column")
    shape = tuple(tr.hist.emb[1].shape)
    del tr, model
    torch.cuda.empty_cache()
    return h, shape


def table_call(lib, h, table) -> torch.Tensor:
    """``lib``'s storage-dtype form on table ``h`` over ``table``."""
    from incagg_gnn_tpu_torch.ops.kernels import TABLE_ROW_TYPES

    r, k = h.ell_cols.shape
    out = torch.empty((r, table.shape[1]), device=table.device)
    rc = lib.ell_spmm_table(TABLE_ROW_TYPES[table.dtype], h.ell_cols.data_ptr(),
                            h.ell_vals.data_ptr(), h.ovf_ptr.data_ptr(),
                            h.ovf_cols.data_ptr(), h.ovf_vals.data_ptr(), table.data_ptr(),
                            out.data_ptr(), r, k, table.shape[1],
                            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"ell_spmm_table: CUDA error {rc}"
    return out


def part_table(device, card: str, parent_src=None) -> None:
    """Kernel B's storage-dtype form on the first global-column eval batch
    of GCN arxiv (D256) and GCNII products (D128), over a cache table of
    normals in f32, bf16, e4m3 and e5m2: the kernel by CUDA events back to
    back and as CUDA-graph replays, and the wrapper alone on the host (the
    same call on zero rows: checks and the output's allocation, no
    launch), beside the bound.  With ``parent_src`` (another
    ``csrc/ell_spmm.cu``), that build against this tree's in turns, each
    ``out`` within 1e-5 of the plain version's largest value."""
    from incagg_gnn_tpu_torch.ops import kernels as K

    lib = parent_lib(parent_src, K.bind_spmm) if parent_src else None
    gen = torch.Generator(device=device).manual_seed(8)
    for tag, yaml_name, block in (("GCN arxiv", "gcn.yaml", "sbm-arxiv"),
                                  ("GCNII products", "gcn2.yaml", "sbm-products-mid")):
        h, shape = refresh_table(yaml_name, block, device)
        r, k = h.ell_cols.shape
        n = int(h.ovf_ptr[-1])
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        named = int(torch.unique(torch.cat([h.ell_cols[h.ell_vals != 0],
                                            h.ovf_cols[:n][h.ovf_vals[:n] != 0]])).numel())
        real = int((h.ell_vals != 0).sum()) + int((h.ovf_vals[:n] != 0).sum())
        deg = (h.ell_vals != 0).sum(1)
        log(f"  {tag} global-column eval batch 0: {r}x{k} +{n} tail over {shape}; {real} "
            f"real slots, {named} distinct rows named; ELL real slots a row: mean "
            f"{float(deg.float().mean()):.1f}, max {int(deg.max())}; {tail_stats(h)} ({card})")
        base = torch.randn(shape, generator=gen, device=device)
        for dtype in K.TABLE_ROW_TYPES:
            table = base.to(dtype)
            d = shape[1]
            moved = (h.ell_cols.numel() * 8 + (r + 1) * 4 + n * 8
                     + named * d * table.element_size() + r * d * 4)
            bound_ms = max(moved / 3.35e12, 2 * real * d / 67e12) * 1e3

            def fn(table=table):
                return K.hybrid_spmm_table(h.ell_cols, h.ell_vals, *tail, table)

            def empty(table=table):
                return K.hybrid_spmm_table(h.ell_cols[:0], h.ell_vals[:0], h.ovf_ptr[:1],
                                           h.ovf_cols, h.ovf_vals, table)

            got = fn()
            want = K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, table)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-5 * scale, f"{tag} {dtype}: err {err} over 1e-5 x {scale}"
            ev_ms, gr_ms = events_ms(fn), graph_ms(fn)
            name = str(dtype).split(".")[-1]
            log(f"    {name}: CUDA events {ev_ms:.4f} ms, "
                f"graph replays {gr_ms:.4f} ms, bound {bound_ms:.4f} ms (share of the "
                f"replay {bound_ms / gr_ms:.3f}); the wrapper alone on the host "
                f"{host_us(empty):.2f} us, a launching call {host_us(fn, 200):.2f} us; "
                f"err {err:.2e} of {scale:.3e} ({card})")
            if lib is None:
                continue
            runs = {who: (lambda lib=l, table=table: table_call(lib, h, table))
                    for who, l in (("parent", lib), ("change", K._lib()))}
            for who, run in runs.items():
                e = float((run() - want).abs().max())
                assert e <= 1e-5 * scale, f"{tag} {name} {who}: err {e}"
            log(f"    turns {name} ({card}): {turns(runs)}")
            del table
        del h, base
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# part 8: the refresh sweep, eager against captured
# ---------------------------------------------------------------------------

#: the refresh configurations: tag, model YAML, its block, overrides
REFRESH_CASES = (
    ("GCN arxiv hybrid GAS", "gcn.yaml", "sbm-arxiv", ("adj_format=hybrid",)),
    ("GCN arxiv block VR", "gcn.yaml", "sbm-arxiv", ("adj_format=block", "vr_update=true")),
    ("GCNII products hybrid VR", "gcn2.yaml", "sbm-products-mid",
     ("adj_format=hybrid", "vr_update=true")),
    ("GAT arxiv hybrid VR", "gat.yaml", "arxiv",
     ("dataset=sbm-arxiv", "adj_format=hybrid", "vr_update=true")))
#: the aggregation kernels, by a part of their names
AGG_KERNELS = ("block_spmm", "ell_spmm", "hybrid_max", "max_bwd_step")


def timed_wrappers():
    """The kernel wrappers, as the port's modules call them, replaced by
    ones that add their host seconds and calls to the returned dict (the
    kernels module itself is left as it is: its counters name its own
    functions).  Returns the dict and an undo function."""
    from incagg_gnn_tpu_torch.ops import kernels as K

    acc = {"s": 0.0, "calls": 0}
    patched = []
    for mod in list(sys.modules.values()):
        if mod is K or not getattr(mod, "__name__", "").startswith("incagg_gnn_tpu_torch"):
            continue
        for name in K.COUNTED:
            fn = getattr(mod, name, None)
            if fn is not None and fn is getattr(K, name):
                def timed(*args, _fn=fn, **kwargs):
                    t = time.perf_counter()
                    out = _fn(*args, **kwargs)
                    acc["s"] += time.perf_counter() - t
                    acc["calls"] += 1
                    return out
                setattr(mod, name, timed)
                patched.append((mod, name, fn))

    def undo():
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return acc, undo


def sweep_trainer(yaml_name: str, block: str, overrides, device):
    """A trainer on the card as the CLI builds it."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    run_cfg = load_config(os.path.join(ROOT, "conf", "model", yaml_name), block,
                          parse_overrides(list(overrides)))
    data, in_c, out_c = get_data("", run_cfg.dataset)
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    return Trainer(model, data, run_cfg.trainer, device)


def part_refresh(device, card: str, reps: int = 5) -> None:
    from incagg_gnn_tpu_torch.ops import kernels as K

    for tag, yaml_name, block, overrides in REFRESH_CASES:
        tr = sweep_trainer(yaml_name, block, overrides, device)
        t = time.perf_counter()
        held = tr.eval_loader.cached()
        torch.cuda.synchronize()
        collate_s = time.perf_counter() - t
        tr.fill_history()  # the eager warm-up of the captured sweep's key

        def sweep(scan: bool):
            tr.model.refresh(tr.tables.x, tr.eval_loader, tr.hist, tr.out_table,
                             vr=tr.cfg.vr_update, use_aggregation=tr.cfg.use_aggregation,
                             scan=scan, host_logits=False)
            torch.cuda.synchronize()

        def walls(scan: bool) -> list:
            out = []
            for _ in range(reps):
                t = time.perf_counter()
                sweep(scan)
                out.append(time.perf_counter() - t)
            return out

        torch.cuda.reset_peak_memory_stats()
        eager = walls(False)
        eager_peak = torch.cuda.max_memory_allocated()
        before = K.launch_counts()
        acc, undo = timed_wrappers()
        try:
            t = time.perf_counter()
            sweep(False)
            timed_s = time.perf_counter() - t
        finally:
            undo()
        launches = {k: v - before[k] for k, v in K.launch_counts().items() if v != before[k]}
        kernels, _, eager_dev = profile(lambda: sweep(False), reps=1)
        agg = sum(us for name, (us, _) in kernels.items()
                  if any(p in name for p in AGG_KERNELS))
        log(f"  {tag}: {len(held)} eval batches held on the "
            f"{'device' if tr.model._last_refresh_plan['on_device'] else 'host'}, "
            f"collated and staged once in {collate_s:.3f} s; eager sweep "
            f"{statistics.median(eager):.4f} s (median of {reps}: "
            f"{[round(w, 4) for w in eager]}); inside the wrappers {acc['s']:.4f} s of "
            f"a {timed_s:.4f} s sweep, {acc['calls']} calls "
            f"({1e6 * acc['s'] / max(acc['calls'], 1):.1f} us a call); launches "
            f"{launches}; device time {eager_dev / 1e3:.3f} ms, aggregation kernels "
            f"{agg / 1e3:.3f} ms; peak device memory {eager_peak} B ({card})")
        print_profile(f"{tag} eager sweep", dict(sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:12]), {}, eager_dev, card)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        sweep(True)  # captures, then replays once
        capture_s = time.perf_counter() - t
        plan = dict(tr.model._last_refresh_plan)
        replays = walls(True)
        captured_peak = torch.cuda.max_memory_allocated()
        kernels, _, graph_dev = profile(lambda: sweep(True), reps=1)
        log(f"  {tag}: captured sweep ({plan['mechanism']}, {plan['captures']} capture(s), "
            f"launches per replay {plan['launches_per_replay']}): capture and first "
            f"replay {capture_s:.4f} s; replay {statistics.median(replays):.4f} s "
            f"(median of {reps}: {[round(w, 4) for w in replays]}); device time "
            f"{graph_dev / 1e3:.3f} ms; peak device memory {captured_peak} B ({card})")
        del tr, held
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m incagg_gnn_tpu_torch.profile_agg")
    ap.add_argument("--part", choices=("all", "agg", "step", "max", "ceiling", "replays",
                                       "heads", "table", "refresh"), default="all")
    ap.add_argument("--parent-src", default=None,
                    help="with --part max: another csrc/ell_max.cu to time against; with "
                         "--part heads or table: another csrc/ell_spmm.cu")
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
    if args.part in ("all", "max"):
        log("part 3: kernel B's max form on PNA's arxiv batches")
        part_max(device, card, args.parent_src if args.part == "max" else None)
    if args.part in ("all", "ceiling"):
        log("part 4: the max form's gathers over x of three sizes")
        part_ceiling(device, card)
    if args.part in ("all", "replays"):
        log("part 5: torch.profiler over a fused epoch's replays")
        part_replays(device, card)
    if args.part in ("all", "heads"):
        log("part 6: kernel B's heads form on GAT's arxiv tables")
        part_heads(device, card, args.parent_src if args.part == "heads" else None)
    if args.part in ("all", "table"):
        log("part 7: kernel B's storage-dtype form on global-column eval batches")
        part_table(device, card, args.parent_src if args.part == "table" else None)
    if args.part in ("all", "refresh"):
        log("part 8: the refresh sweep, eager against captured")
        part_refresh(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
