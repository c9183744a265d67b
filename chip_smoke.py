"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

0. the card's name and power limit (``nvidia-smi``); CUDA is required;
1. build the three CUDA kernels and the native graph library from the
   repository's sources, timing the builds;
2. compare each kernel with its plain PyTorch version on the card, on
   inputs built the way the slices build them (one 40-cluster batch of
   ``sbm-arxiv``; one single-cluster batch of ``sbm-products-mid``), with
   times from CUDA events (median of 20), the time of one PyTorch library
   call computing the same function (a yardstick the port never calls) and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak, whichever is larger);
3. check the CUDA runs against the port's CPU runs (plain versions) on
   ``sbm-small``, GCN and GCNII (this also warms up the training path, so
   that the first large run's phases do not carry the process's one-time
   CUDA set-up);
4. drive the port's main paths through its CLI entry point, with the
   kernels' launch counters reset just before each run, and check that the
   kernels ran in every phase: GCN at the arxiv configuration on
   ``sbm-arxiv`` (``adj_format=block`` in GAS and Reverb/VR,
   ``adj_format=hybrid`` in GAS beside them), and GCNII at the products
   configuration on ``sbm-products-mid`` (``adj_format=block`` in GAS and
   VR, ``adj_format=hybrid`` in GAS), one epoch each.

The line before the last is a JSON object of the kernels' measurements;
the last line is ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GCN_YAML = os.path.join(ROOT, "conf", "model", "gcn.yaml")
GCN2_YAML = os.path.join(ROOT, "conf", "model", "gcn2.yaml")
TOL = 1e-5  # max |kernel - plain| <= TOL * max |plain|: f32 sums in another order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
KERNELS = ("block_spmm", "ell_spmm", "ell_reduce")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warm_s: float = 0.025) -> float:
    """Median device time of one call, by CUDA events, after a warm-up of
    at least ``warm_s`` seconds of calls (the clocks settle after host
    work; a few calls of a 0.1 ms kernel are too short for that)."""
    t_end = time.perf_counter() + warm_s
    for i in range(1000):
        fn()
        torch.cuda.synchronize()
        if i >= 2 and time.perf_counter() > t_end:
            break
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: int, ops: int, dtype=torch.float32) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the type's peak."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved_bytes, "ops": ops}


def compare(name, kernel_fn, plain_fn, cost: dict, library_fn=None) -> dict:
    """Run kernel and plain version on the same inputs, check the
    tolerance, time both (and the library yardstick, checked loosely)."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > TOL * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err:.3e} over tolerance "
                             f"{TOL:g} x max|plain| {scale:.3e}")
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    res = {"case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, **cost}
    lib = ""
    if library_fn is not None:
        lib_err = float((library_fn() - want).abs().max())
        if not lib_err <= 1e-4 * max(scale, 1e-30):
            raise AssertionError(f"{name}: the library call computes another "
                                 f"function (max abs err {lib_err:.3e})")
        res["library_ms"] = time_ms(library_fn)
        lib = f" library {res['library_ms']:.4f} ms (err {lib_err:.2e})"
    log(f"  {name}: max_abs_err {err:.3e} (max|plain| {scale:.3e}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib} bound "
        f"{cost['bound_ms']:.4f} ms by {cost['bound_by']} "
        f"({cost['bytes']} B, {cost['ops']} ops; share "
        f"{cost['bound_ms'] / ms:.3f})")
    return res


# ---------------------------------------------------------------------------
# phase 2: inputs, costs and library yardsticks of each kernel
# ---------------------------------------------------------------------------

def batch_csr(dataset: str, parts: int, clusters: int):
    """One normalized, relabeled GAS batch of the first ``clusters``
    clusters, as the loader builds it (seed 42)."""
    import numpy as np

    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.graph.relabel import relabel_one_hop

    t = time.perf_counter()
    data, _, _ = get_data("", dataset)
    perm, ptr = partition_graph(data.adj_t, parts, seed=42)
    data = permute(data, perm)
    data.adj_t = gcn_norm(data.adj_t.set_diag())
    idx = np.arange(ptr[0], ptr[clusters])
    rowptr, col, val, n_id = relabel_one_hop(data.adj_t, idx)
    r_pad = -(-len(idx) // 128) * 128
    c_pad = -(-len(n_id) // 128) * 128
    log(f"  {dataset} batch ({clusters} of {parts} clusters): {len(idx)} rows "
        f"({r_pad} padded), {len(n_id)} columns ({c_pad} padded), {len(col)} "
        f"edges [{time.perf_counter() - t:.1f}s]")
    return rowptr, col, val, r_pad, c_pad


def block_cost(dense, x, num_rows: int) -> dict:
    """The least work of kernel A's function, whatever implements it: read
    the tiles' nonzeros once (``rowptr``, ``cols``, ``vals``), each distinct
    x row they reference once, and write the output once; two operations
    per nonzero and column."""
    x_rows = int(torch.unique(dense.cols).numel())
    moved = (nbytes(dense.rowptr, dense.cols, dense.vals)
             + x_rows * x.shape[1] * x.element_size() + num_rows * x.shape[1] * 4)
    ops = 2 * int((dense.vals != 0).sum()) * x.shape[1]
    return bound(moved, ops, dense.vals.dtype)


def ell_cost(cols, vals, x) -> dict:
    ops = 2 * int((vals != 0).sum()) * x.shape[1]
    return bound(nbytes(cols, vals, x) + cols.shape[0] * x.shape[1] * 4, ops)


def reduce_cost(g, vals) -> dict:
    ops = 2 * int((vals != 0).sum()) * g.shape[2]
    return bound(nbytes(g, vals) + g.shape[0] * g.shape[2] * 4, ops)


def _csr(rows, cols, vals, shape):
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def tiles_csr(dense, num_rows: int, x_rows: int):
    """The tiles' nonzeros as one CSR matrix ``[num_rows, x_rows]`` (the
    library operand of kernel A)."""
    rowptr = dense.rowptr.long()
    rows = torch.arange(rowptr.numel() - 1, device=rowptr.device).repeat_interleave(
        rowptr.diff())
    keep = (rows < num_rows) & (dense.vals != 0)
    return _csr(rows[keep], dense.cols.long()[keep], dense.vals[keep].float(),
                (num_rows, x_rows))


def ell_csr(cols, vals, x_rows: int):
    """The ELL slots' edges as one CSR matrix (the library operand of
    kernel B)."""
    r, k = cols.shape
    rows = torch.arange(r, device=cols.device).repeat_interleave(k)
    keep = vals.reshape(-1) != 0
    return _csr(rows[keep], cols.reshape(-1).long()[keep], vals.reshape(-1)[keep],
                (r, x_rows))


def kernel_cases(device, dataset, parts, clusters, d_main, widths, main_tag):
    """Phase 2 on one batch: kernel A on the forward tiles at each tile
    height, f32 and bf16, on the transposed tiles and on incidence tiles;
    kernel B on the batch's ELL tables; kernel C on the ``[R, K, D]`` gather
    of one of them.  ``main_tag`` marks the cases of the ``kernels`` line."""
    import numpy as np

    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.ops.block import (
        BF16, build_block_hybrid, marginal_thresh, nonempty_tiles,
        plan_block_tier_rb, transpose_csr_host)
    from incagg_gnn_tpu_torch.ops.ell import build_hybrid_adj, choose_k

    rowptr, col, val, r_pad, c_pad = batch_csr(dataset, parts, clusters)
    plan = plan_block_tier_rb(rowptr, col, c_pad, d_hint=d_main)
    thresh, rb_main = plan if plan is not None else (marginal_thresh(4, 4, d_main), 128)
    k_model = choose_k(np.diff(rowptr))
    log(f"  tile plan thresh={thresh} rb={rb_main}; ELL width K={k_model}")
    gen = torch.Generator(device=device).manual_seed(0)

    def rand_x(rows, d, dtype=torch.float32):
        return torch.randn(rows, d, generator=gen, device=device).to(dtype)

    results = {name: [] for name in KERNELS}

    # kernel A: forward tiles at each tile height, f32 and bf16; transposed
    # and incidence tiles at the main tile height
    cases = []
    for rb in (128, 256, 512):
        for a_dtype in (np.float32, BF16):
            dense = build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh,
                                       a_dtype=a_dtype, rb_rows=rb).dense
            kind = "bf16" if a_dtype == BF16 else "f32"
            ws = widths if rb == rb_main else (d_main,)
            for d in ws:
                cases.append((f"A fwd rb{rb} {kind} D{d}", dense, r_pad, c_pad, d))
    t_rowptr, t_col, t_val = transpose_csr_host(rowptr, col, val, c_pad)
    dense_t = build_block_hybrid(t_rowptr, t_col, t_val, c_pad, r_pad, thresh,
                                 rb_rows=rb_main).dense
    cases.append((f"A bwd rb{rb_main} f32 D{d_main}", dense_t, c_pad, r_pad, d_main))
    inc = build_hybrid_adj(rowptr, col, val, r_pad, c_pad, k=8, ovf_inc=True).ovf_inc
    n_inc = inc.cols2.shape[0]
    for d in (d_main, 40):
        cases.append((f"A incidence lanes4 f32 D{d}", inc, r_pad, n_inc, d))

    main_a = f"A fwd rb{rb_main} f32 D{d_main}"
    for name, dense, rows, x_rows, d in cases:
        dev = dense.to(device)
        x = rand_x(x_rows, d, dev.vals.dtype)
        lib_fn = None
        if name == main_a:
            csr = tiles_csr(dev, rows, x_rows)
            lib_fn = lambda csr=csr, x=x: torch.sparse.mm(csr, x)  # noqa: E731
        res = compare(f"{dataset} {name} ({dev.bcols.numel()} tiles, "
                      f"{nonempty_tiles(dev)} non-empty, {dev.vals.numel()} entries)",
                      lambda: K.block_spmm(dev, x, rows),
                      lambda: K.block_spmm_reference(dev, x, rows),
                      block_cost(dev, x, rows), lib_fn)
        res["main"] = main_tag and name == main_a
        results["block_spmm"].append(res)
        del dev, x, lib_fn

    # kernel B: the batch's ELL tables at K = 8, the cost-model width and 32;
    # pad slots point at the trash column with weight 0
    for k in sorted({8, k_model, 32}):
        hyb = build_hybrid_adj(rowptr, col, val, r_pad, c_pad, k=k).to(device)
        for d in widths:
            x = rand_x(c_pad, d)
            main = k == k_model and d == d_main
            lib_fn = None
            if main:
                csr = ell_csr(hyb.ell_cols, hyb.ell_vals, c_pad)
                lib_fn = lambda csr=csr, x=x: torch.sparse.mm(csr, x)  # noqa: E731
            res = compare(f"{dataset} B ell K{k} D{d} ({r_pad} rows)",
                          lambda: K.ell_spmm(hyb.ell_cols, hyb.ell_vals, x),
                          lambda: K.ell_spmm_reference(hyb.ell_cols, hyb.ell_vals, x),
                          ell_cost(hyb.ell_cols, hyb.ell_vals, x), lib_fn)
            res["main"] = main_tag and main
            results["ell_spmm"].append(res)

            # kernel C: the same table's rows gathered into [R, K, D]
            if main:
                g = x.index_select(0, hyb.ell_cols.reshape(-1).long()).reshape(
                    r_pad, k, d)
                vals = hyb.ell_vals
                res = compare(f"{dataset} C reduce K{k} D{d} ({r_pad} rows)",
                              lambda: K.ell_reduce(g, vals),
                              lambda: K.ell_reduce_reference(g, vals),
                              reduce_cost(g, vals),
                              lambda: torch.bmm(vals[:, None, :], g)[:, 0])
                res["main"] = main_tag
                results["ell_reduce"].append(res)
                del g
            del x, lib_fn
        del hyb
    # odd R and D for kernel C: the Pallas version needed R % 128 == 0
    g = torch.randn(r_pad - 77, 5, d_main - 3, generator=gen, device=device)
    vals = torch.rand(r_pad - 77, 5, generator=gen, device=device)
    res = compare(f"{dataset} C reduce odd R{g.shape[0]} K5 D{g.shape[2]}",
                  lambda: K.ell_reduce(g, vals),
                  lambda: K.ell_reduce_reference(g, vals), reduce_cost(g, vals))
    res["main"] = False
    results["ell_reduce"].append(res)
    torch.cuda.empty_cache()
    return results


def phase_kernels(device) -> dict:
    """Phase 2: every kernel against its plain version at the shapes of both
    slices (sbm-arxiv: 40-cluster GAS batch, widths 256/128/40;
    sbm-products-mid: single-cluster batch, width 128, the only width
    GCNII aggregates)."""
    arxiv = kernel_cases(device, "sbm-arxiv", 80, 40, 256, (256, 128, 40), True)
    prod = kernel_cases(device, "sbm-products-mid", 30, 1, 128, (128,), False)
    return {k: arxiv[k] + prod[k] for k in KERNELS}


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

def run_slice(yaml: str, dataset: str, fmt: str, vr: bool, extra=()) -> dict:
    """The CLI entry point, in-process, counters reset first.  Block runs
    must launch kernels A and B in the fill, train and eval phases; hybrid
    runs kernel B (they hold no dense tiles)."""
    from incagg_gnn_tpu_torch.__main__ import main
    from incagg_gnn_tpu_torch.ops import kernels as K

    argv = ["--model", yaml, "--dataset", dataset, f"adj_format={fmt}",
            "epochs=1", f"vr_update={'true' if vr else 'false'}", *extra]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(K, name).launches = 0
    t = time.perf_counter()
    res = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {name: getattr(K, name).launches for name in KERNELS}
    tag = f"{os.path.basename(yaml)} {dataset} {fmt} {'VR' if vr else 'GAS'}"

    ep = res["epochs"][0]
    nums = [ep["loss"], ep["train_acc"], ep["val_acc"], ep["test_acc"],
            res["fill"]["train_acc"]]
    if not all(math.isfinite(v) for v in nums):
        raise AssertionError(f"{tag}: non-finite loss/accuracy {nums}")
    if ep["steps"] < 1:
        raise AssertionError(f"{tag}: no training step ran")
    required = ("block_spmm", "ell_spmm") if fmt == "block" else ("ell_spmm",)
    if fmt == "block" and res["dense_tiles"] <= 0:
        raise AssertionError(f"{tag}: no dense tile with an edge: the block "
                             f"tier did not engage")
    prev = dict.fromkeys(KERNELS, 0)
    for phase in ("fill", "train0", "eval0"):
        now = res["launches"][phase]
        for k in required:
            if now[k] <= prev[k]:
                raise AssertionError(f"{tag}: kernel {k} not launched in phase {phase}")
        prev = now
    peak = torch.cuda.max_memory_allocated()
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  {tag}: loss {ep['loss']:.4f} train {ep['train_acc']:.4f} "
        f"val {ep['val_acc']:.4f} test {ep['test_acc']:.4f} steps {ep['steps']}")
    log(f"  {tag}: dense tiles (eval batches, non-empty) {res['dense_tiles']}; "
        f"cumulative launches after each phase {json.dumps(res['launches'])}")
    log(f"  {tag}: seconds " + json.dumps({k: round(v, 3) for k, v in res['phases'].items()})
        + f" wall {wall:.3f}; max_memory_allocated {peak} bytes; host peak "
        f"RSS of the process so far {host_peak} bytes")
    return {"counts": counts, "phases": res["phases"], "peak_bytes": peak}


def check_small_reference() -> None:
    """Phase 3: the CUDA run agrees with the CPU run (plain versions) on
    sbm-small, same seed, dropout 0, GCN and GCNII."""
    from incagg_gnn_tpu_torch.__main__ import main

    for yaml in (GCN_YAML, GCN2_YAML):
        for vr in ("false", "true"):
            tag = f"{os.path.basename(yaml)} sbm-small vr={vr}"
            argv = ["--model", yaml, "--dataset", "sbm-small", "adj_format=block",
                    "epochs=1", "dropout=0.0", f"vr_update={vr}"]
            gpu = main(argv + ["--device", "cuda"])
            cpu = main(argv + ["--device", "cpu"])
            lg, lc = gpu["epochs"][0]["loss"], cpu["epochs"][0]["loss"]
            if abs(lg - lc) > 1e-4 * max(1.0, abs(lc)):
                raise AssertionError(f"{tag}: loss cuda {lg} cpu {lc}")
            # same parameters: the fill's accuracies agree exactly; after a
            # step a few near-tie nodes may flip their argmax
            if gpu["fill"] != cpu["fill"]:
                raise AssertionError(f"{tag}: fill cuda {gpu['fill']} cpu {cpu['fill']}")
            for key in ("train_acc", "val_acc", "test_acc"):
                a, b = gpu["epochs"][0][key], cpu["epochs"][0][key]
                if abs(a - b) > 0.01:
                    raise AssertionError(f"{tag}: {key} cuda {a} cpu {b}")
            log(f"  {tag}: loss cuda {lg:.6f} cpu {lc:.6f}; "
                f"val acc cuda {gpu['epochs'][0]['val_acc']:.4f} "
                f"cpu {cpu['epochs'][0]['val_acc']:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    log("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    log("phase 1: build")
    from incagg_gnn_tpu_torch.ops.kernels import build_kernels
    from incagg_gnn_tpu_torch.utils import native

    t = time.perf_counter()
    native.native_lib()
    log(f"  graph library: {time.perf_counter() - t:.2f} s")
    kernel_s = build_kernels()
    log(f"  kernels: {kernel_s:.2f} s")
    with open(os.path.join(ROOT, "build", "kernels_build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())

    log("phase 2: kernels vs plain versions, library calls and bounds")
    t = time.perf_counter()
    kres = phase_kernels(device)
    log(f"  phase 2: {time.perf_counter() - t:.1f} s")

    log("phase 3: CUDA vs CPU on sbm-small")
    t = time.perf_counter()
    check_small_reference()
    log(f"  phase 3: {time.perf_counter() - t:.1f} s")

    log("phase 4: main paths")
    t = time.perf_counter()
    runs = [run_slice(GCN_YAML, "sbm-arxiv", "block", vr=False),
            run_slice(GCN_YAML, "sbm-arxiv", "block", vr=True),
            run_slice(GCN_YAML, "sbm-arxiv", "hybrid", vr=False),
            run_slice(GCN2_YAML, "sbm-products-mid", "block", vr=False),
            run_slice(GCN2_YAML, "sbm-products-mid", "block", vr=True),
            run_slice(GCN2_YAML, "sbm-products-mid", "hybrid", vr=False)]
    log(f"  phase 4: {time.perf_counter() - t:.1f} s")

    src = {"block_spmm": ("incagg_gnn_tpu_torch/csrc/block_spmm.cu",
                          "incagg_gnn_tpu/ops/block.py:488"),
           "ell_spmm": ("incagg_gnn_tpu_torch/csrc/ell_spmm.cu",
                        "incagg_gnn_tpu/ops/pallas_spmm.py:74"),
           "ell_reduce": ("incagg_gnn_tpu_torch/csrc/ell_reduce.cu",
                          "incagg_gnn_tpu/ops/pallas_spmm.py:105")}
    kernels = []
    for name, (source, replaces) in src.items():
        main_case = next(r for r in kres[name] if r["main"])
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["counts"][name] for r in runs),
            "max_abs_err": max(r["max_abs_err"] for r in kres[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "lib_ms": main_case["library_ms"],
            "case": main_case["case"],
        }
        if name == "ell_reduce":
            if entry["launches"]:
                raise AssertionError("ell_reduce ran on a main path: no path calls it")
            entry["note"] = "no path of either package calls it: 0 main-path launches"
        kernels.append(entry)
    log(f"  total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
