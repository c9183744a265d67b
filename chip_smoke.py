"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

0. the card's name and power limit (``nvidia-smi``); CUDA is required;
1. build the two CUDA kernels and the native graph library from the
   repository's sources, timing the builds;
2. compare each kernel with its plain PyTorch version on the card, on
   inputs built the way the slice builds them (one 40-cluster batch of
   ``sbm-arxiv``), with times from CUDA events (median of 20);
3. drive the port's main path through its CLI entry point — GCN at the
   arxiv configuration on ``sbm-arxiv``, ``adj_format=block``, one epoch,
   in GAS and in Reverb/VR mode — with the kernels' launch counters reset
   just before, and check that both kernels ran in every phase;
4. check the CUDA run against the port's CPU run (plain versions) on
   ``sbm-small``.

The line before the last is a JSON object of the kernels' measurements;
the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GCN_YAML = os.path.join(ROOT, "conf", "model", "gcn.yaml")
TOL = 1e-5  # max |kernel - plain| <= TOL * max |plain|: f32 sums in another order


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
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


def compare(name, kernel_fn, plain_fn) -> dict:
    """Run kernel and plain version on the same inputs, check the
    tolerance, time both."""
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
    log(f"  {name}: max_abs_err {err:.3e} (max|plain| {scale:.3e}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return {"case": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(device) -> dict:
    """Phase 2: both kernels against their plain versions at the slice's
    shapes (tiles, ELL tables and widths of a 40-cluster sbm-arxiv batch)."""
    import numpy as np

    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.graph.relabel import relabel_one_hop
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.ops.block import (
        BF16, build_block_hybrid, marginal_thresh, plan_block_tier_rb,
        transpose_csr_host)
    from incagg_gnn_tpu_torch.ops.ell import build_hybrid_adj, choose_k

    t = time.perf_counter()
    data, _, _ = get_data("", "sbm-arxiv")
    perm, ptr = partition_graph(data.adj_t, 80, seed=42)
    data = permute(data, perm)
    data.adj_t = gcn_norm(data.adj_t.set_diag())
    idx = np.arange(ptr[0], ptr[40])
    rowptr, col, val, n_id = relabel_one_hop(data.adj_t, idx)
    r_pad = -(-len(idx) // 128) * 128
    c_pad = -(-len(n_id) // 128) * 128
    plan = plan_block_tier_rb(rowptr, col, c_pad, d_hint=256)
    thresh, rb_main = plan if plan is not None else (marginal_thresh(4, 4, 256), 128)
    log(f"  batch: {len(idx)} rows ({r_pad} padded), {len(n_id)} columns "
        f"({c_pad} padded), {len(col)} edges; tile plan thresh={thresh} "
        f"rb={rb_main} [{time.perf_counter() - t:.1f}s]")

    gen = torch.Generator(device=device).manual_seed(0)

    def rand_x(rows, d, dtype=torch.float32):
        return torch.randn(rows, d, generator=gen, device=device).to(dtype)

    results = {"block_spmm": [], "ell_spmm": []}

    # kernel A: the forward tiles at each tile height, the transposed tiles,
    # f32 and bf16, widths 256 (hidden), 128 (features) and 40 (classes)
    cases = []
    for rb in (128, 256, 512):
        for a_dtype in (np.float32, BF16):
            dense = build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh,
                                       a_dtype=a_dtype, rb_rows=rb).dense
            kind = "bf16" if a_dtype == BF16 else "f32"
            widths = (256, 128, 40) if rb == rb_main else (256,)
            for d in widths:
                cases.append((f"A fwd rb{rb} {kind} D{d}", dense, r_pad, c_pad, d))
    t_rowptr, t_col, t_val = transpose_csr_host(rowptr, col, val, c_pad)
    dense_t = build_block_hybrid(t_rowptr, t_col, t_val, c_pad, r_pad, thresh,
                                 rb_rows=rb_main).dense
    cases.append((f"A bwd rb{rb_main} f32 D256", dense_t, c_pad, r_pad, 256))
    # lanes 4: the overflow-incidence tiles of the batch's hybrid at K=8
    inc = build_hybrid_adj(rowptr, col, val, r_pad, c_pad, k=8, ovf_inc=True).ovf_inc
    n_inc = inc.a.shape[0] * 128
    for d in (256, 40):
        cases.append((f"A incidence lanes4 f32 D{d}", inc, r_pad, n_inc, d))

    main_a = f"A fwd rb{rb_main} f32 D256"
    for name, dense, rows, x_rows, d in cases:
        dev = dense.to(device)
        x = rand_x(x_rows, d, dev.a.dtype)
        nnz_tiles = int((dev.a.reshape(dev.a.shape[0], -1) != 0).any(1).sum())
        res = compare(f"{name} ({dev.a.shape[0]} tiles, {nnz_tiles} non-empty)",
                      lambda: K.block_spmm(dev, x, rows),
                      lambda: K.block_spmm_reference(dev, x, rows))
        res["main"] = name == main_a
        results["block_spmm"].append(res)

    # kernel B: the batch's ELL tables at K = 8, the cost-model width and 32;
    # pad slots point at the trash column with weight 0
    k_model = choose_k(np.diff(rowptr))
    for k in sorted({8, k_model, 32}):
        hyb = build_hybrid_adj(rowptr, col, val, r_pad, c_pad, k=k).to(device)
        for d in (256, 128, 40):
            x = rand_x(c_pad, d)
            res = compare(f"B ell K{k} D{d} ({r_pad} rows)",
                          lambda: K.ell_spmm(hyb.ell_cols, hyb.ell_vals, x),
                          lambda: K.ell_spmm_reference(hyb.ell_cols, hyb.ell_vals, x))
            res["main"] = k == k_model and d == 256
            results["ell_spmm"].append(res)
    return results


def run_slice(vr: bool) -> dict:
    """Phase 3: the CLI entry point, in-process, counters reset first."""
    from incagg_gnn_tpu_torch.__main__ import main
    from incagg_gnn_tpu_torch.ops.kernels import block_spmm, ell_spmm

    argv = ["--model", GCN_YAML, "--dataset", "sbm-arxiv", "adj_format=block",
            "epochs=1", f"vr_update={'true' if vr else 'false'}"]
    torch.cuda.reset_peak_memory_stats()
    block_spmm.launches = 0
    ell_spmm.launches = 0
    t = time.perf_counter()
    res = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {"block_spmm": block_spmm.launches, "ell_spmm": ell_spmm.launches}
    mode = "VR" if vr else "GAS"

    ep = res["epochs"][0]
    nums = [ep["loss"], ep["train_acc"], ep["val_acc"], ep["test_acc"],
            res["fill"]["train_acc"]]
    if not all(math.isfinite(v) for v in nums):
        raise AssertionError(f"{mode}: non-finite loss/accuracy {nums}")
    if ep["steps"] < 1:
        raise AssertionError(f"{mode}: no training step ran")
    if res["dense_tiles"] <= 0:
        raise AssertionError(f"{mode}: no dense tile with an edge: the block "
                             f"tier did not engage")
    prev = {"block_spmm": 0, "ell_spmm": 0}
    for phase in ("fill", "train0", "eval0"):
        now = res["launches"][phase]
        for k in now:
            if now[k] <= prev[k]:
                raise AssertionError(f"{mode}: kernel {k} not launched in phase {phase}")
        prev = now
    peak = torch.cuda.max_memory_allocated()
    log(f"  {mode}: loss {ep['loss']:.4f} train {ep['train_acc']:.4f} "
        f"val {ep['val_acc']:.4f} test {ep['test_acc']:.4f} steps {ep['steps']}")
    log(f"  {mode}: dense tiles (eval batches, non-empty) {res['dense_tiles']}; "
        f"launches per phase {json.dumps(res['launches'])}")
    log(f"  {mode}: seconds " + json.dumps({k: round(v, 3) for k, v in res['phases'].items()})
        + f" wall {wall:.3f}; max_memory_allocated {peak} bytes")
    return {"counts": counts, "phases": res["phases"], "peak_bytes": peak}


def check_small_reference() -> None:
    """Phase 4: the CUDA run agrees with the CPU run (plain versions) on
    sbm-small, same seed, dropout 0."""
    from incagg_gnn_tpu_torch.__main__ import main

    for vr in ("false", "true"):
        argv = ["--model", GCN_YAML, "--dataset", "sbm-small", "adj_format=block",
                "epochs=1", "dropout=0.0", f"vr_update={vr}"]
        gpu = main(argv + ["--device", "cuda"])
        cpu = main(argv + ["--device", "cpu"])
        lg, lc = gpu["epochs"][0]["loss"], cpu["epochs"][0]["loss"]
        if abs(lg - lc) > 1e-4 * max(1.0, abs(lc)):
            raise AssertionError(f"sbm-small vr={vr}: loss cuda {lg} cpu {lc}")
        # same parameters: the fill's accuracies agree exactly; after a step
        # a few near-tie nodes may flip their argmax
        if gpu["fill"] != cpu["fill"]:
            raise AssertionError(f"sbm-small vr={vr}: fill cuda {gpu['fill']} "
                                 f"cpu {cpu['fill']}")
        for key in ("train_acc", "val_acc", "test_acc"):
            a, b = gpu["epochs"][0][key], cpu["epochs"][0][key]
            if abs(a - b) > 0.01:
                raise AssertionError(f"sbm-small vr={vr}: {key} cuda {a} cpu {b}")
        log(f"  sbm-small vr={vr}: loss cuda {lg:.6f} cpu {lc:.6f}; "
            f"val acc cuda {gpu['epochs'][0]['val_acc']:.4f} "
            f"cpu {cpu['epochs'][0]['val_acc']:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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

    log("phase 2: kernels vs plain versions")
    kres = phase_kernels(device)

    log("phase 3: main path (sbm-arxiv, GCN arxiv widths, adj_format=block)")
    runs = [run_slice(vr=False), run_slice(vr=True)]

    log("phase 4: CUDA vs CPU on sbm-small")
    check_small_reference()

    src = {"block_spmm": ("incagg_gnn_tpu_torch/csrc/block_spmm.cu",
                          "incagg_gnn_tpu/ops/block.py:488"),
           "ell_spmm": ("incagg_gnn_tpu_torch/csrc/ell_spmm.cu",
                        "incagg_gnn_tpu/ops/pallas_spmm.py:74")}
    kernels = []
    for name, (source, replaces) in src.items():
        main_case = next(r for r in kres[name] if r["main"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["counts"][name] for r in runs),
            "max_abs_err": max(r["max_abs_err"] for r in kres[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        })
        log(f"  {name}: ms/plain_ms below are of case '{main_case['case']}'")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
