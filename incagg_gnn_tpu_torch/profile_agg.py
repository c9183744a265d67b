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


def parent_lib(src: str):
    """Build ``src`` (a version of ``csrc/ell_max.cu`` with the same C
    interface) into ``build/parent_ell_max.so`` and bind it."""
    import ctypes

    from incagg_gnn_tpu_torch.ops.kernels import _nvcc, bind_max_form

    so = os.path.join(ROOT, "build", "parent_ell_max.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", so, src]
    subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
    return bind_max_form(ctypes.CDLL(so))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m incagg_gnn_tpu_torch.profile_agg")
    ap.add_argument("--part", choices=("all", "agg", "step", "max", "ceiling", "replays"),
                    default="all")
    ap.add_argument("--parent-src", default=None,
                    help="with --part max: another csrc/ell_max.cu to time against")
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
        part_max(device, card, args.parent_src)
    if args.part in ("all", "ceiling"):
        log("part 4: the max form's gathers over x of three sizes")
        part_ceiling(device, card)
    if args.part in ("all", "replays"):
        log("part 5: torch.profiler over a fused epoch's replays")
        part_replays(device, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
