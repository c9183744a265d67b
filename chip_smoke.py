"""Smoke test of the PyTorch port on one CUDA GPU.

Run from the repository root, on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

0. the card's name and power limit (``nvidia-smi``); CUDA is required;
1. build the CUDA kernels and the native graph library from the
   repository's sources, timing the builds;
2. compare each kernel with its plain PyTorch version on the card, on
   inputs built the way the slices build them (one 40-cluster batch of
   ``sbm-arxiv``; one single-cluster batch of ``sbm-products-mid``; one
   single-cluster batch of ``sbm-reddit-mid``, binarized as GraphSAGE
   aggregates it, at its widths 602 and 1024, with the COO path's plain
   sum timed beside for the record; kernel B's heads form on one
   40-cluster GAT batch of ``sbm-arxiv`` at four heads of 64, the forward
   table and its transpose, with the attention values of random scores;
   kernel B's max form, forward with and without the tie counts and its
   backward over the transpose, on one 40-cluster PNA batch of
   ``sbm-arxiv``, binarized, at the widths 128 and 40 of one branch and
   768 and 240 of six stacked branches, the forward's ``out`` and ``ties``
   required equal to the plain version's bit for bit and the backward's
   ``dx`` equal when called twice, with the time of ``index_select`` +
   ``torch.segment_reduce`` beside the forward as a two-call yardstick, the
   forward again on the eval loader's first single-cluster batch at 768
   and 240 and kernel B's heads form on GAT's (also timed as CUDA-graph
   replays: those launches take microseconds; the heads form's training
   tables too), and the fused kernel B
   on the same tables at PNA's stacked sum/mean widths),
   with
   times from CUDA events (20 calls back to back, median of 3 such runs),
   the time of one PyTorch library
   call computing the same function (a yardstick the port never calls) and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak, whichever is larger); kernel B also on the
   loader-built hybrid pair's tables, alone and fused with the overflow
   tail, beside the unfused composition it replaces and its gather rate;
3. check the CUDA runs against the port's CPU runs (plain versions) on
   ``sbm-small``, GCN, GCNII, GraphSAGE, APPNP, GAT and PNA (this also warms up
   the training path, so
   that the first large run's phases do not carry the process's one-time
   CUDA set-up);
4. drive the port's main paths through its CLI entry point, with the
   kernels' launch counters reset just before each run, and check that the
   kernels ran in every phase, kernel B always fused with its overflow
   tail: GCN at the arxiv configuration on
   ``sbm-arxiv`` (``adj_format=block`` in GAS and Reverb/VR,
   ``adj_format=hybrid`` in GAS beside them), GCNII at the products
   configuration on ``sbm-products-mid`` (``adj_format=block`` in GAS and
   VR, ``adj_format=hybrid`` in GAS), GraphSAGE at the reddit widths on
   ``sbm-reddit-mid`` (block GAS and VR, hybrid GAS, and GAS with edge
   dropout 0.2, which trains on the COO format and launches no kernel in
   training), APPNP at the arxiv configuration on ``sbm-arxiv`` (hybrid
   GAS, block VR) and GAT at the arxiv configuration on ``sbm-arxiv``
   (hybrid GAS and VR, which launch kernel B's heads form in every phase,
   and COO GAS, which launches no kernel) and PNA at the arxiv
   configuration on ``sbm-arxiv`` (hybrid GAS, VR mock and VR
   ``true_vr``, and PNA_JK hybrid GAS, which launch kernel B and its max
   form in every phase and the max form's backward in training), one epoch
   each;
5. a short accuracy check: GCN GAS with the accuracy suite's protocol, one
   run of 20 epochs on ``sbm-products-hard-v4``; its test accuracy at the
   best validation epoch must lie within 0.02 of the JAX package's
   (``docs/accuracy_suite_prod_r05.json``);
6. spill, checkpoint, supervise: (a) GCNII at the products configuration
   on ``sbm-products-mid`` with ``--spill`` (history caches in pinned host
   memory, staged on a copy stream), hybrid GAS and block VR, one epoch
   each: loss and val accuracy equal to phase 4's device-cache run of the
   same format and mode (loss within 1e-5·|loss|, val within 1e-4), the
   kernels launched in every phase, and the peak device memory below that
   run's by at least 0.8x the caches' bytes; and PNA at the arxiv
   configuration with ``true_vr`` (hybrid VR) the same way, its memory
   reported only; (b) GCN at the arxiv
   configuration on ``sbm-arxiv``, hybrid GAS, two epochs, each run a
   child process of the CLI: an uninterrupted run with
   ``--checkpoint-dir``; a run under ``--supervise 2`` with the watchdog
   armed and a device loss injected at the end of epoch 1, before its
   checkpoint (``INCAGG_FAULT_INJECT=epoch=1``), which must restart once
   from epoch 0's checkpoint and reproduce the uninterrupted run's epoch 1
   (loss within 1e-5·|loss|, val within 1e-4); and ``--eval-only
   --save-logits`` from that checkpoint directory, which must reproduce the
   last evaluation within 1e-4 and write ``[N, C]`` logits in the original
   node order;
7. the fused epoch and the global-column refresh: (a) GCN at the arxiv
   configuration on ``sbm-arxiv`` (block GAS, hybrid GAS and VR, three
   epochs), GCNII at the products configuration on ``sbm-products-mid``
   (hybrid GAS, block VR, two epochs) and PNA at the arxiv configuration
   (hybrid GAS, three epochs: the max form and its backward in every
   step), each trained
   from one filled state with ``fused_epoch=auto``
   (the epoch as CUDA-graph replays of one captured step, where the JAX
   predicate allows it) and with ``off`` (the step loop), each epoch's path,
   train seconds and launches per replay printed: at dropout 0 the loss of
   every epoch and the caches after them within 1e-6 relative of the loop's,
   and an epoch fused by replay in every configuration; with the
   configuration's dropout both losses printed, GCN's runs three times each
   way with the median and spread of each epoch's train seconds; (b) on the trained state of
   each hybrid configuration, a refresh over the eval loader's global-column
   batches (kernel B's storage-dtype form) against one over batch-local
   batches: logits and caches within 1e-5 of their largest value, both
   refreshes timed; (c) kernel B's storage-dtype form against its plain
   version on the first global-column eval batch of GCN arxiv (D256) and of
   GCNII products (D128), the cache table in f32, bf16, float8_e4m3fn and
   float8_e5m2, with its time (also as CUDA-graph replays), bound,
   launches per refresh and, in f32, cuSPARSE on the same batch; (d) resume across a fused epoch, at the
   configuration's dropout (GCN arxiv hybrid VR, 0.5, and GCNII products
   block VR): a checkpoint saved after the first fused epoch, restored into
   a fresh trainer, whose next epoch must be fused and equal the
   uninterrupted run's bit for bit in loss, every state tensor and the
   logits; (e) one fused epoch of each GCNII configuration and of PNA arxiv
   under ``torch.profiler``, after a capture anew: the kernels the card ran,
   counted by name, must equal the launch counters and the replays times the
   launches per replay (the max form's backward counted by its last gather,
   one a call), and the backward's ``max_bwd_step_kernel`` ceil(D / chunk)
   times for each call of width D in the capture; and, counted
   independently of the profiler, the kernel nodes of the captured graph
   (kept with ``keep_graph=True`` and read through ``libcuda``) must
   hold the launches per replay of each kernel and its ``max_bwd_step_kernel``s;
8. datasets on disk, the inductive (PPI) protocol and neighbor sampling:
   (a) three ``sbm-ppi`` graphs at PyG PPI's size and shape (44,906 training
   nodes, 121 labels, 50 features, degree ~27.3; val and test graphs of
   ``num_nodes // 4``) written as PyG PPI raw files, converted by ``python -m
   incagg_gnn_tpu_torch.convert_dataset --format ppi`` (the archives must
   hold the graphs' arrays), then GraphSAGE with ``graphsage.yaml``'s ``ppi``
   block unchanged (3 x 1024, residual, 40 parts, 10 clusters a batch)
   through the CLI on ``--dataset ppi``, GAS and VR, 30 epochs: every
   inductive eval (whole-graph forwards on the val and test graphs) must
   launch kernel B or kernel A, and the last epoch's val and test micro-F1
   must lie above the fill's (untrained logits); (b) GraphSAGE at the
   ``sbm-reddit-mid`` block, hybrid GAS with ``num_neighbors=25``, two
   epochs: kernel B fused in every training phase, every sampled batch at
   most 25 entries a row, no batch of epoch 1 drawn as one of epoch 0, and
   every ``train_epoch`` record looped for the ``ns`` reason, its seconds
   beside phase 4's unsampled run; (c, in phase 2) at D1024, the full
   forward's whole-graph batch of the val graph as it collates it
   (``block-fwd``: kernel A on the dense tier's tiles, the fused kernel B
   on the remainder), the fused kernel B on the whole graph (``hybrid-fwd``)
   and on both tables of one ``ns`` training batch;
9. the refresh sweep as captured CUDA graphs (``models/base.py::refresh``,
   ``scan=True``): (a) GCN at the arxiv configuration (hybrid GAS, global
   columns; block VR), GCNII at the products configuration (hybrid VR,
   global columns, 30 batches x 5 layers), GAT, PNA and APPNP at their arxiv
   configurations (hybrid VR; hybrid GAS; hybrid GAS) on ``sbm-arxiv``,
   each from one trained state (its fill, the eager warm-up of the sweep's
   graph, and one epoch): 5 eager sweeps (``scan=False``) against the
   captured sweep's capture and 5 replays, each captured result equal to
   the eager one bit for bit (else within 1e-6 of the largest value,
   printed), ``mechanism: sweep``, the counters (set to 0 before) equal to
   the replays times the launches per replay with the configuration's
   kernels among them, and the captured graph's kernel nodes (read through
   ``libcuda``) equal to the launches per replay; the median seconds each
   way, the capture's and the peak device memory each way (above what was
   allocated when each refresh began) printed; (b) on
   GCN arxiv hybrid GAS, ``refresh_frac=0.25`` and the eval set held on the
   host, each refresh through ``layers`` and equal to its eager twin; (c)
   after ``restore_checkpoint`` the next refresh captures anew and equals
   the eager sweep, and on GraphSAGE at the ``ppi`` block a ``full_forward``
   of the val graph leaves the trainer's graph, which the next refresh
   replays with no capture; (d) the staleness suite (``python -m
   incagg_gnn_tpu_torch.staleness_stress``) at 1 run x 10 epochs on
   ``gas-stress``, ``vr-stress-drift``, ``gas-stress-period3`` and
   ``gas-frozen``, each refresh's mechanism counted (``layers`` for the
   windows and the refreshes inside an epoch, ``sweep`` for the EMA, none
   eager).  Phase 2 also times kernel A on the first single-cluster
   ``block-fwd`` eval batch of GCN arxiv (D256) and GCNII products (D128),
   by events and as CUDA-graph replays;
10. the sharded trainer (``parallel/``), 4 ranks sharing the card over
   gloo: (a) GCNII at the products configuration, Reverb and GAS, against
   the single-device fill; (b) over NCCL at world size 1; (c) GCN arxiv at
   2 layers, card against CPU; (d) the CLI with a checkpoint and a resume; (e) NCCL
   over two GPUs where there are two;
11. sharded GAT and PNA and the sharded spill tier
   (``parallel/spill_sharded.py``), 4 ranks sharing the card over gloo, one
   spawn: (a) GAT at the arxiv configuration on ``sbm-arxiv``, Reverb (the
   hybrid pair with ``t2f``) and GAS (COO), 2 epochs each, and (b) PNA at
   the arxiv configuration, Reverb ``true_vr`` and GAS (hybrid), 2 epochs
   each: each fill against the single-device ``Trainer``'s from the same
   parameters (1e-4 x max|logits|; bit for bit reported), every rank
   launching kernel B's heads form (GAT Reverb) or both max forms with
   every kernel B launch fused (PNA); (c) GCNII products Reverb with the
   caches in host memory against phase 10 (a)'s Reverb run (fill logits
   and losses bit for bit, each rank's peak device memory at least 0.3 GB
   lower); (d) GCN arxiv GAS spilled against the same run with device
   caches (bit for bit); (e) the CLI: ``--spill --n-devices 4`` one epoch
   with a checkpoint, then a resume to epoch 2 with
   ``INCAGG_HBM_BUDGET_MB=64`` and no ``--spill``, where the memory gate
   must choose the spill tier and log it;
12. the refresh's pipelined halo exchange and the port's scaling tools,
   4 ranks sharing the card over gloo: (a) phase 10 (a)'s Reverb fill (the
   refresh collects round r+1's halo while round r computes) equal to
   phase 7's single-device refresh bit for bit, then on each rank a
   serial refresh (rebuilt from ``collect`` / ``assemble`` /
   ``_refresh_batch``) and a pipelined one from the same state, equal bit
   for bit, with their seconds, the time blocked on all-to-all
   handles (the wire's hidden share) and the peak device memory; (b)
   ``python -m incagg_gnn_tpu_torch.scaling_bench`` at its full width
   (GCN 3 x 256, GAS) on 50,000 nodes of 16 parts, ranks 1, 2 and 4 over
   gloo and one NCCL row at world size 1, full against ``loopback``, its
   rows printed and its artifact consistent or stamped invalid with
   reasons; (c) the CLI's ``--runs 2 --n-devices 2`` on GCN arxiv, each
   run's line and the summary matched; (d) GCNII products Reverb with
   bfloat16 caches spilled against its device-cache twin (phase 11's
   spawn; fill logits and losses bit for bit), and the memory gate on 2
   ranks under ``torchrun`` with ``INCAGG_HBM_BUDGET_MB=0`` (GCN on
   ``sbm-small``, ``--runs 2``:
   the log names the spill tier each run).  ``--phases 10``, ``11`` and
   ``12`` run a phase alone.

The line before the last is a JSON object of the kernels' measurements;
the last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import dataclasses
import gc
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GCN_YAML = os.path.join(ROOT, "conf", "model", "gcn.yaml")
GCN2_YAML = os.path.join(ROOT, "conf", "model", "gcn2.yaml")
SAGE_YAML = os.path.join(ROOT, "conf", "model", "graphsage.yaml")
APPNP_YAML = os.path.join(ROOT, "conf", "model", "appnp.yaml")
GAT_YAML = os.path.join(ROOT, "conf", "model", "gat.yaml")
PNA_YAML = os.path.join(ROOT, "conf", "model", "pna.yaml")
ACCURACY_REF = os.path.join(ROOT, "docs", "accuracy_suite_prod_r05.json")
TOL = 1e-5  # max |kernel - plain| <= TOL * max |plain|: f32 sums in another order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
KERNELS = ("block_spmm", "ell_spmm", "ell_reduce", "hybrid_max", "hybrid_max_bwd")
# hybrid_spmm: kernel B's fused launches; hybrid_spmm_heads: those with H > 1;
# hybrid_spmm_table: its storage-dtype form (global-column refreshes)
COUNTERS = KERNELS + ("hybrid_spmm", "hybrid_spmm_heads", "hybrid_spmm_table")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, windows: int = 3, warm_s: float = 0.025) -> float:
    """Device time of one call, by CUDA events around ``reps`` calls issued
    back to back (so the host's enqueue of the next call overlaps the
    device's work), the median over ``windows`` such runs; after a warm-up
    of at least ``warm_s`` seconds of calls (the clocks settle after host
    work; a few calls of a 0.1 ms kernel are too short for that)."""
    t_end = time.perf_counter() + warm_s
    for i in range(1000):
        fn()
        torch.cuda.synchronize()
        if i >= 2 and time.perf_counter() > t_end:
            break
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


def compare(name, kernel_fn, plain_fn, cost: dict, library_fn=None,
            unfused_fn=None, gathered: int = 0) -> dict:
    """Run kernel and plain version on the same inputs, check the
    tolerance, time both (and the library yardstick, checked loosely).
    ``unfused_fn`` (the composition a fused kernel replaces) is checked to
    the same tolerance and timed beside it; ``gathered`` bytes give the
    kernel's achieved gather rate."""
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
    if unfused_fn is not None:
        un_err = float((unfused_fn() - want).abs().max())
        if not un_err <= TOL * max(scale, 1e-30):
            raise AssertionError(f"{name}: the unfused composition disagrees "
                                 f"(max abs err {un_err:.3e})")
        res["unfused_ms"] = time_ms(unfused_fn)
        lib += f" unfused {res['unfused_ms']:.4f} ms (err {un_err:.2e})"
    if gathered:
        res["gather_gb_s"] = gathered / ms * 1e-6
        lib += f" gather {res['gather_gb_s']:.1f} GB/s"
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
    clusters, as the loader builds it (seed 42), and the training loader's
    hybrid pair of the same clusters (its own pad buckets)."""
    import numpy as np

    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.graph.relabel import relabel_one_hop
    from incagg_gnn_tpu_torch.loader import SubgraphLoader

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
    loader = SubgraphLoader(data, ptr, "cpu", batch_size=clusters, mode="gas",
                            shuffle=True, seed=42, adj_format="hybrid")
    pair = loader._collate(loader._groups(shuffled=False)[0]).device.adj
    return rowptr, col, val, r_pad, c_pad, pair


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


def gathered_rows(cols, vals) -> int:
    """Distinct x rows that the slots of nonzero weight name."""
    return int(torch.unique(cols[vals != 0]).numel())


def ell_cost(cols, vals, x) -> dict:
    """The least work of kernel B's ELL sum, whatever implements it: read
    the table once, each distinct x row its real slots name once, and
    write the output once; two operations per real slot and column."""
    moved = (nbytes(cols, vals) + gathered_rows(cols, vals) * x.shape[1] * 4
             + cols.shape[0] * x.shape[1] * 4)
    return bound(moved, 2 * int((vals != 0).sum()) * x.shape[1])


def hybrid_real(h) -> int:
    """Real slots of a hybrid table: the ELL slots and the overflow entries
    its row pointer covers, of nonzero weight."""
    n = int(h.ovf_ptr[-1])
    return int((h.ell_vals != 0).sum()) + int((h.ovf_vals[:n] != 0).sum())


def hybrid_cost(h, x) -> dict:
    """The fused call's least work: the ELL table, the row pointer and the
    real overflow entries read once, each distinct x row they name once,
    out written once; two operations per real slot and column."""
    n = int(h.ovf_ptr[-1])
    cols = torch.cat([h.ell_cols.reshape(-1), h.ovf_cols[:n]])
    vals = torch.cat([h.ell_vals.reshape(-1), h.ovf_vals[:n]])
    moved = (nbytes(h.ell_cols, h.ell_vals, h.ovf_ptr) + n * 8
             + gathered_rows(cols, vals) * x.shape[1] * 4
             + h.ell_cols.shape[0] * x.shape[1] * 4)
    return bound(moved, 2 * hybrid_real(h) * x.shape[1])


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


def hybrid_csr(h, x_rows: int):
    """The whole hybrid table (ELL real slots and the real overflow) as one
    CSR matrix: the library operand of the fused kernel B."""
    r, k = h.ell_cols.shape
    n = int(h.ovf_ptr[-1])
    rows = torch.cat([torch.arange(r, device=h.ell_cols.device).repeat_interleave(k),
                      h.ovf_rows[:n].long()])
    cols = torch.cat([h.ell_cols.reshape(-1).long(), h.ovf_cols[:n].long()])
    vals = torch.cat([h.ell_vals.reshape(-1), h.ovf_vals[:n]])
    keep = vals != 0
    return _csr(rows[keep], cols[keep], vals[keep], (r, x_rows))


def ell_csr(cols, vals, x_rows: int):
    """The ELL slots' edges as one CSR matrix (the library operand of
    kernel B)."""
    r, k = cols.shape
    rows = torch.arange(r, device=cols.device).repeat_interleave(k)
    keep = vals.reshape(-1) != 0
    return _csr(rows[keep], cols.reshape(-1).long()[keep], vals.reshape(-1)[keep],
                (r, x_rows))


def kernel_cases(device, dataset, parts, clusters, d_main, widths, main_tag,
                 fused):
    """Phase 2 on one batch: kernel A on the forward tiles at each tile
    height, f32 and bf16, on the transposed tiles and on incidence tiles;
    kernel B on the batch's ELL tables, and on the loader-built hybrid
    pair's tables alone and fused with their overflow tails (``fused``:
    ``(side, D)`` cases); kernel C on the ``[R, K, D]`` gather of one of
    them.  ``main_tag`` marks the cases of the ``kernels`` line."""
    import numpy as np

    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.ops.block import (
        BF16, build_block_hybrid, marginal_thresh, nonempty_tiles,
        plan_block_tier_rb, transpose_csr_host)
    from incagg_gnn_tpu_torch.ops.ell import build_hybrid_adj, choose_k

    rowptr, col, val, r_pad, c_pad, pair = batch_csr(dataset, parts, clusters)
    plan = plan_block_tier_rb(rowptr, col, c_pad, d_hint=d_main)
    thresh, rb_main = plan if plan is not None else (marginal_thresh(4, 4, d_main), 128)
    k_model = choose_k(np.diff(rowptr))
    log(f"  tile plan thresh={thresh} rb={rb_main}; ELL width K={k_model}")
    gen = torch.Generator(device=device).manual_seed(0)

    def rand_x(rows, d, dtype=torch.float32):
        return torch.randn(rows, d, generator=gen, device=device).to(dtype)

    results = {name: [] for name in ("block_spmm", "ell_spmm", "ell_reduce")}

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
    # the library yardstick at the main width and at APPNP's 40 columns
    with_lib = (main_a, f"A fwd rb{rb_main} f32 D40")
    for name, dense, rows, x_rows, d in cases:
        dev = dense.to(device)
        x = rand_x(x_rows, d, dev.vals.dtype)
        lib_fn = None
        if name in with_lib:
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
    # kernel B on the loader's tables: the ELL core alone, then fused with
    # the overflow tail, beside the unfused composition it replaces (the
    # ELL-only kernel, index_select, *, index_add) and cuSPARSE over the
    # whole table as one CSR
    pair = pair.to(device)
    for side, d in fused:
        h = pair.fwd if side == "fwd" else pair.bwd
        x_rows = (pair.bwd if side == "fwd" else pair.fwd).num_rows
        x = rand_x(x_rows, d)
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        real_ell = int((h.ell_vals != 0).sum())
        tag = (f"{dataset} B loader {side} {tuple(h.ell_cols.shape)} "
               f"+{int(h.ovf_ptr[-1])} tail D{d}")
        csr = ell_csr(h.ell_cols, h.ell_vals, x_rows)
        res = compare(f"{tag}: ELL core",
                      lambda: K.ell_spmm(h.ell_cols, h.ell_vals, x),
                      lambda: K.ell_spmm_reference(h.ell_cols, h.ell_vals, x),
                      ell_cost(h.ell_cols, h.ell_vals, x),
                      lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                      gathered=real_ell * d * 4)
        res["main"] = False
        results["ell_spmm"].append(res)

        def unfused(h=h, x=x):
            go = x.index_select(0, h.ovf_cols) * h.ovf_vals[:, None]
            return K.ell_spmm(h.ell_cols, h.ell_vals, x).index_add(0, h.ovf_rows, go)

        csr = hybrid_csr(h, x_rows)
        res = compare(f"{tag}: fused",
                      lambda: K.hybrid_spmm(h.ell_cols, h.ell_vals, *tail, x),
                      lambda: K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x),
                      hybrid_cost(h, x), lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                      unfused_fn=unfused, gathered=hybrid_real(h) * d * 4)
        res["main"] = False
        results["ell_spmm"].append(res)
        del x, csr
    del pair

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


def reddit_cases(device, widths=(602, 1024)) -> dict:
    """Phase 2 at GraphSAGE's reddit widths on one single-cluster
    ``sbm-reddit-mid`` batch (degree ~100), binarized as GraphSAGE
    aggregates it: kernel A over rb512 tiles of 1.0 values, the fused
    kernel B on both tables of the loader's hybrid pair, each at D602 (not
    a multiple of 4: the scalar paths) and D1024; and, for the record, the
    COO format's plain sum (``ops/spmm.py``, no kernel) against cuSPARSE."""
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.ops.block import build_block_hybrid, plan_block_tier_rb
    from incagg_gnn_tpu_torch.ops.spmm import build_padded_adj, spmm as spmm_coo

    rowptr, col, val, r_pad, c_pad, pair = batch_csr("sbm-reddit-mid", 20, 1)
    plan = plan_block_tier_rb(rowptr, col, c_pad, d_hint=1024, rb_candidates=(512,))
    thresh = plan[0] if plan is not None else 8
    gen = torch.Generator(device=device).manual_seed(1)
    results = {"block_spmm": [], "ell_spmm": []}

    dense = build_block_hybrid(rowptr, col, val, r_pad, c_pad, thresh,
                               rb_rows=512).to(device).binarized().dense
    csr = tiles_csr(dense, r_pad, c_pad)
    for d in widths:
        x = torch.randn(c_pad, d, generator=gen, device=device)
        res = compare(f"sbm-reddit-mid A fwd rb512 f32 binarized D{d} "
                      f"(thresh {thresh}, {dense.vals.numel()} entries)",
                      lambda: K.block_spmm(dense, x, r_pad),
                      lambda: K.block_spmm_reference(dense, x, r_pad),
                      block_cost(dense, x, r_pad),
                      lambda csr=csr, x=x: torch.sparse.mm(csr, x))
        res["main"] = False
        results["block_spmm"].append(res)
    del dense, csr

    pair = pair.to(device).binarized()
    for side in ("fwd", "bwd"):
        h = pair.fwd if side == "fwd" else pair.bwd
        x_rows = (pair.bwd if side == "fwd" else pair.fwd).num_rows
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        csr = hybrid_csr(h, x_rows)
        for d in widths:
            x = torch.randn(x_rows, d, generator=gen, device=device)
            res = compare(f"sbm-reddit-mid B loader {side} binarized "
                          f"{tuple(h.ell_cols.shape)} +{int(h.ovf_ptr[-1])} tail D{d}: fused",
                          lambda: K.hybrid_spmm(h.ell_cols, h.ell_vals, *tail, x),
                          lambda: K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x),
                          hybrid_cost(h, x), lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                          gathered=hybrid_real(h) * d * 4)
            res["main"] = False
            results["ell_spmm"].append(res)
        del csr
    del pair

    e_pad = -(-len(col) // 128) * 128
    coo = build_padded_adj(rowptr, col, val, r_pad, c_pad, e_pad).to(device).binarized()
    csr = _csr(coo.rows.long(), coo.cols.long(), coo.vals, (r_pad, c_pad))
    for d in widths:
        x = torch.randn(c_pad, d, generator=gen, device=device)
        got, want = spmm_coo(coo, x), torch.sparse.mm(csr, x)
        err = float((got - want).abs().max())
        if not err <= TOL * float(want.abs().max()):
            raise AssertionError(f"COO sum D{d}: max abs err {err:.3e} against cuSPARSE")
        cost = bound(nbytes(coo.rows, coo.cols, coo.vals)
                     + gathered_rows(coo.cols, coo.vals) * d * 4 + r_pad * d * 4,
                     2 * int((coo.vals != 0).sum()) * d)
        ms, lib_ms = time_ms(lambda: spmm_coo(coo, x)), time_ms(lambda: torch.sparse.mm(csr, x))
        log(f"  sbm-reddit-mid COO plain sum binarized D{d} ({e_pad} edges): "
            f"{ms:.4f} ms, cuSPARSE {lib_ms:.4f} ms (err {err:.2e}), bound "
            f"{cost['bound_ms']:.4f} ms by {cost['bound_by']} (share "
            f"{cost['bound_ms'] / ms:.3f})")
    torch.cuda.empty_cache()
    return results


def heads_case(tag: str, h, ve, vo, x, heads: int, dh: int, graph_time=False) -> dict:
    """Kernel B's heads form on one hybrid table with per-head values ``ve
    [R, K, H]``, ``vo [O, H]``, fused with its tail, against its plain
    version; the library yardstick is one cuSPARSE product per head, their
    times summed.  ``graph_time``: also the kernel's time as CUDA-graph
    replays (``profile_agg.py::graph_ms``)."""
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.profile_agg import graph_ms

    device = x.device
    x_rows = int(x.shape[0])
    n = int(h.ovf_ptr[-1])
    args = (h.ell_cols, ve, h.ovf_ptr, h.ovf_cols, vo, x)
    # the least work: the table and its values read once, each distinct x
    # row the taken slots name once, the output written once
    real_e = ve.ne(0).any(-1)
    real_o = vo[:n].ne(0).any(-1)
    cols = torch.cat([h.ell_cols[real_e], h.ovf_cols[:n][real_o]])
    moved = (nbytes(h.ell_cols, ve, h.ovf_ptr) + n * (4 + 4 * heads)
             + int(torch.unique(cols).numel()) * heads * dh * 4
             + h.num_rows * heads * dh * 4)
    cost = bound(moved, 2 * int(real_e.sum() + real_o.sum()) * heads * dh)
    tag = (f"{tag} {tuple(h.ell_cols.shape)}x{heads} +{n} tail H{heads} Dh{dh}: fused")
    res = compare(tag, lambda: K.hybrid_spmm_heads(*args),
                  lambda: K.hybrid_spmm_heads_reference(*args), cost)
    r, k = h.ell_cols.shape
    rows = torch.cat([torch.arange(r, device=device).repeat_interleave(k),
                      h.ovf_rows[:n].long()])
    cols_all = torch.cat([h.ell_cols.reshape(-1).long(), h.ovf_cols[:n].long()])
    vals = torch.cat([ve.reshape(-1, heads), vo[:n]])
    csrs = [_csr(rows[vals[:, j] != 0], cols_all[vals[:, j] != 0],
                 vals[vals[:, j] != 0, j], (r, x_rows)) for j in range(heads)]
    xs = [x[:, j * dh:(j + 1) * dh].contiguous() for j in range(heads)]
    lib = torch.cat([torch.sparse.mm(c, xj) for c, xj in zip(csrs, xs)], 1)
    want = K.hybrid_spmm_heads_reference(*args)
    lib_err = float((lib - want).abs().max())
    if not lib_err <= 1e-4 * float(want.abs().max()):
        raise AssertionError(f"{tag}: the per-head library calls compute another "
                             f"function (max abs err {lib_err:.3e})")
    res["library_ms"] = sum(time_ms(lambda c=c, xj=xj: torch.sparse.mm(c, xj))
                            for c, xj in zip(csrs, xs))
    res["library"] = f"{heads} x torch.sparse.mm (one per head), times summed"
    res["main"] = False
    log(f"    library: {res['library']} {res['library_ms']:.4f} ms (err {lib_err:.2e})")
    if graph_time:
        res["graph_ms"] = graph_ms(lambda: K.hybrid_spmm_heads(*args))
        log(f"    as CUDA-graph replays (no host launch cost): kernel {res['graph_ms']:.4f} ms")
    return res


def gat_cases(device, heads: int = 4, dh: int = 64) -> list:
    """Phase 2, kernel B's heads form on GAT's arxiv path
    (``profile_agg.py::gat_tables``): one 40-cluster ``sbm-arxiv`` batch
    collated as the GAT trainer collates it (no self loops, no
    normalization, the hybrid pair with its permutation), the attention
    values of random scores with attention dropout 0.5 (zeros in single
    heads), on the forward table (the message sum) and on the transpose
    (``d_wx``, the values moved through ``t2f``), fused with each table's
    tail, and on the eval loader's first single-cluster batch (forward
    table, no dropout); each also as CUDA-graph replays.  The library
    yardstick is one cuSPARSE product per head, their times summed."""
    from incagg_gnn_tpu_torch.profile_agg import gat_tables

    t = time.perf_counter()
    tables = gat_tables(device, heads)
    log(f"  sbm-arxiv GAT tables built [{time.perf_counter() - t:.1f}s]")
    gen = torch.Generator(device=device).manual_seed(2)
    tags = {"forward": "GAT B heads fwd", "transpose": "GAT B heads bwd",
            "eval batch 0": "GAT eval batch 0 B heads fwd"}
    results = []
    for name, h, ve, vo, x_rows in tables:
        x = torch.randn(x_rows, heads * dh, generator=gen, device=device)
        results.append(heads_case(f"sbm-arxiv {tags[name]}", h, ve, vo, x, heads, dh,
                                  graph_time=True))
        del x
    del tables
    torch.cuda.empty_cache()
    return results


def real_slots(h):
    """Rows and columns of a hybrid table's real slots (ELL, then the
    covered tail), and the count of the tail's entries."""
    device = h.ell_cols.device
    r, k = h.ell_cols.shape
    n = int(h.ovf_ptr[-1])
    rows = torch.cat([torch.arange(r, device=device).repeat_interleave(k),
                      h.ovf_rows[:n].long()])
    cols = torch.cat([h.ell_cols.reshape(-1).long(), h.ovf_cols[:n].long()])
    keep = torch.cat([h.ell_vals.reshape(-1), h.ovf_vals[:n]]) != 0
    return rows[keep], cols[keep], n


def max_table_bytes(h, n: int) -> int:
    """The max form's table bytes: the ELL table, the row pointer, the
    degrees and the covered tail read once."""
    return nbytes(h.ell_cols, h.ell_vals, h.ovf_ptr, h.deg) + n * 8


def max_fwd_case(tag: str, h, x, ties: bool, graph_time=False) -> dict:
    """The max form's forward on table ``h`` against its plain version (out
    and ties equal bit for bit), timed with its plain version, its bound
    and the two-call yardstick: ``index_select`` then
    ``torch.segment_reduce(max)`` over the real slots in row order (no
    single PyTorch call computes the row max of a hybrid table)."""
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.profile_agg import graph_ms

    device = x.device
    tables = (h.ell_cols, h.ell_vals, h.ovf_ptr, h.ovf_cols, h.ovf_vals, h.deg, x)
    rows, cols, n = real_slots(h)
    got, got_t = K.hybrid_max(*tables, want_ties=ties)
    want, want_t = K.hybrid_max_reference(*tables, want_ties=ties)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or (ties and not torch.equal(got_t, want_t)):
        raise AssertionError(f"{tag}: the kernel's out or ties differ from the plain "
                             f"version's")
    r_pad, d = h.num_rows, int(x.shape[1])
    moved = (max_table_bytes(h, n) + int(torch.unique(cols).numel()) * d * 4
             + r_pad * d * 4 * (2 if ties else 1))
    cost = bound(moved, 2 * int(cols.numel()) * d)
    ms = time_ms(lambda: K.hybrid_max(*tables, want_ties=ties))
    plain_ms = time_ms(lambda: K.hybrid_max_reference(*tables, want_ties=ties))
    seg_cols = cols[torch.argsort(rows, stable=True)]
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=device),
                         torch.bincount(rows, minlength=r_pad).cumsum(0)])

    def yardstick():
        return torch.segment_reduce(x.index_select(0, seg_cols), "max", offsets=offsets,
                                    axis=0)

    has = h.deg > 0
    y_err = float((yardstick()[has] - want[has]).abs().max())
    if y_err != 0.0:
        raise AssertionError(f"{tag}: the yardstick computes another function "
                             f"(max abs err {y_err:.3e})")
    y_ms = time_ms(yardstick)
    extra = {}
    if graph_time:
        extra = {"graph_ms": graph_ms(lambda: K.hybrid_max(*tables, want_ties=ties))}
        log(f"  {tag}: as CUDA-graph replays (no host launch cost) {extra['graph_ms']:.4f} ms")
    log(f"  {tag}: exact (out{' and ties' if ties else ''}); kernel {ms:.4f} ms "
        f"plain {plain_ms:.4f} ms; yardstick (two calls: "
        f"index_select + segment_reduce max; -inf on rows of degree 0) {y_ms:.4f} ms; "
        f"bound {cost['bound_ms']:.4f} ms by {cost['bound_by']} ({cost['bytes']} B, "
        f"{cost['ops']} ops; share {cost['bound_ms'] / ms:.3f})")
    return {"case": tag, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "yardstick_ms": y_ms,
            "yardstick": "index_select + torch.segment_reduce(max), two calls",
            "main": False, **extra, **cost}


def pna_cases(device, dataset: str = "sbm-arxiv", parts: int = 80, clusters: int = 40,
              widths=(128, 768, 40, 240)) -> dict:
    """Phase 2, kernel B's max form on PNA's arxiv path: one 40-cluster
    ``sbm-arxiv`` batch collated as the PNA trainer collates it (no self
    loops, no normalization, the hybrid pair), binarized as PNA aggregates
    it, at one branch's widths (128, 40) and at six branches stacked (768,
    240); x is relu'd normals (about half of it exactly 0, so ties are
    common), the stacked widths' second half negated as the min branches
    pass it.  The forward with and without the tie counts must equal the
    plain version bit for bit (:func:`max_fwd_case`); the backward over the
    transpose within ``TOL``, and equal bit for bit when called again.  The
    eval loader's first single-cluster batch, forward only, at 768 and 240.
    Then the fused kernel B on both tables at the stacked sum/mean widths
    768 and 240, beside cuSPARSE."""
    from incagg_gnn_tpu_torch.graph.csr import permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
    from incagg_gnn_tpu_torch.ops import kernels as K

    t = time.perf_counter()
    data, _, _ = get_data("", dataset)
    perm, ptr = partition_graph(data.adj_t, parts, seed=42)
    data = permute(data, perm)
    loader = SubgraphLoader(data, ptr, "cpu", batch_size=clusters, mode="gas", shuffle=True,
                            seed=42, adj_format="hybrid")
    pair = loader._collate(loader._groups(shuffled=False)[0]).device.adj.to(device).binarized()
    f, b = pair.fwd, pair.bwd
    r_pad, c_pad = f.num_rows, b.num_rows
    log(f"  {dataset} PNA batch ({clusters} of {parts} clusters): forward "
        f"{tuple(f.ell_cols.shape)} +{int(f.ovf_ptr[-1])} tail, transpose "
        f"{tuple(b.ell_cols.shape)} +{int(b.ovf_ptr[-1])} tail, "
        f"{int((f.deg == 0).sum())} rows of degree 0 [{time.perf_counter() - t:.1f}s]")
    gen = torch.Generator(device=device).manual_seed(3)
    fwd_tables = (f.ell_cols, f.ell_vals, f.ovf_ptr, f.ovf_cols, f.ovf_vals)
    bwd_tables = (b.ell_cols, b.ell_vals, b.ovf_ptr, b.ovf_cols, b.ovf_vals)
    f_n = int(f.ovf_ptr[-1])
    _, b_cols, b_n = real_slots(b)
    b_named = int(torch.unique(b_cols).numel())
    results = {"hybrid_max": [], "hybrid_max_bwd": []}
    for d in widths:
        x = torch.randn(c_pad, d, generator=gen, device=device).relu_()
        x[1::7] = x[0]
        if d > 128:  # six stacked branches: three max, three min (negated)
            x[:, d // 2:] = -x[:, d // 2:]
        for ties in (True, False):
            tag = (f"{dataset} PNA B max fwd {tuple(f.ell_cols.shape)} +{f_n} tail D{d}"
                   f"{' with ties' if ties else ''}")
            res = max_fwd_case(tag, f, x, ties)
            res["main"] = d == 768 and not ties
            results["hybrid_max"].append(res)
        out, tie_counts = K.hybrid_max(*fwd_tables, f.deg, x, want_ties=True)
        g = torch.randn(r_pad, d, generator=gen, device=device)
        args = (*bwd_tables, g, tie_counts, out, x, f.deg)
        # the least work: the transpose's table and real tail, each distinct
        # forward row its real slots name once in g, ties and out, the
        # forward degrees, x read and dx written once
        cost = bound(max_table_bytes(b, b_n) + b_named * d * 4 * 3 + c_pad * d * 4 * 2,
                     3 * int(b_cols.numel()) * d)
        res = compare(f"{dataset} PNA B max bwd {tuple(b.ell_cols.shape)} +{b_n} tail D{d}",
                      lambda: K.hybrid_max_bwd(*args),
                      lambda: K.hybrid_max_bwd_reference(*args), cost)
        if not torch.equal(K.hybrid_max_bwd(*args), K.hybrid_max_bwd(*args)):
            raise AssertionError(f"max form bwd D{d}: two calls on the same inputs differ")
        res["main"] = d == 768
        results["hybrid_max_bwd"].append(res)
        del x, out, tie_counts, g, args
    # the eval loader's first single-cluster batch, as a PNA eval or refresh
    # aggregates it: the forward without ties
    ev = EvalSubgraphLoader(data, ptr, "cpu", batch_size=1, adj_format="hybrid-fwd")
    h = ev.cached()[0].wait().device.adj.to(device).binarized()
    x_rows = int(max(int(h.ell_cols.max()), int(h.ovf_cols.max()))) + 1
    for d in (768, 240):
        x = torch.randn(x_rows, d, generator=gen, device=device).relu_()
        x[1::7] = x[0]
        x[:, d // 2:] = -x[:, d // 2:]
        tag = (f"{dataset} PNA eval batch 0 B max fwd {tuple(h.ell_cols.shape)} "
               f"+{int(h.ovf_ptr[-1])} tail over {x_rows} x rows D{d}")
        results["hybrid_max"].append(max_fwd_case(tag, h, x, False, graph_time=True))
        del x
    # kernel B, fused, on the same tables at the stacked sum/mean widths
    # (six branches: the hidden layers' 768, the last layer's 240)
    results["ell_spmm"] = []
    for side, h, x_rows in (("fwd", f, c_pad), ("bwd", b, r_pad)):
        csr = hybrid_csr(h, x_rows)
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        for d in (768, 240):
            x = torch.randn(x_rows, d, generator=gen, device=device).relu_()
            res = compare(f"{dataset} PNA B loader {side} binarized "
                          f"{tuple(h.ell_cols.shape)} +{int(h.ovf_ptr[-1])} tail D{d}: fused",
                          lambda: K.hybrid_spmm(h.ell_cols, h.ell_vals, *tail, x),
                          lambda: K.hybrid_spmm_reference(h.ell_cols, h.ell_vals, *tail, x),
                          hybrid_cost(h, x), lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                          gathered=hybrid_real(h) * d * 4)
            res["main"] = False
            results["ell_spmm"].append(res)
            del x
        del csr
    del pair, f, b
    torch.cuda.empty_cache()
    return results


def eval_block_cases(device) -> list:
    """Phase 2, kernel A on the eval batches it runs most: the first
    single-cluster ``block-fwd`` eval batch of GCN arxiv (80 parts, D256)
    and of GCNII products (30 parts, D128), collated as the trainer's eval
    loader collates it with ``adj_format=block`` (self loops, the
    normalization, the dense tier forced, its cost model at the hidden
    width); by CUDA events and as CUDA-graph replays (an eval launch takes
    microseconds), beside the plain version, cuSPARSE on the tiles'
    nonzeros and the bound."""
    import numpy as np

    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.profile_agg import graph_ms

    gen = torch.Generator(device=device).manual_seed(9)
    out = []
    for tag, dataset, parts, d in (("GCN arxiv", "sbm-arxiv", 80, 256),
                                   ("GCNII products", "sbm-products-mid", 30, 128)):
        data, _, _ = get_data("", dataset)
        perm, ptr = partition_graph(data.adj_t, parts, seed=42)
        data = permute(data, perm)
        data.adj_t = gcn_norm(data.adj_t.set_diag(), add_self_loops=False)
        ev = EvalSubgraphLoader(data, ptr, "cpu", adj_format="block-fwd", block_d_hint=d,
                                block_force=True)
        adj = ev._collate(np.array([0])).device.adj.to(device)
        if not hasattr(adj, "dense"):
            raise AssertionError(f"{tag} eval batch 0: the dense tier did not engage")
        dense, rows, x_rows = adj.dense, adj.num_rows, ev.buckets.cols
        x = torch.randn(x_rows, d, generator=gen, device=device)
        res = compare(f"{tag} eval batch 0 A fwd rb{dense.rb} f32 D{d} ({rows} rows, "
                      f"{dense.vals.numel()} entries)",
                      lambda: K.block_spmm(dense, x, rows),
                      lambda: K.block_spmm_reference(dense, x, rows),
                      block_cost(dense, x, rows),
                      lambda csr=tiles_csr(dense, rows, x_rows): torch.sparse.mm(csr, x))
        res["graph_ms"] = graph_ms(lambda: K.block_spmm(dense, x, rows))
        log(f"    as CUDA-graph replays (no host launch cost): kernel {res['graph_ms']:.4f} "
            f"ms, share of the bound {res['bound_ms'] / res['graph_ms']:.3f}")
        res["main"] = False
        out.append(res)
        del x, adj, ev, data
    torch.cuda.empty_cache()
    return out


def phase_kernels(device, ppi_val) -> dict:
    """Phase 2: every kernel against its plain version at the shapes of the
    slices (sbm-arxiv: 40-cluster GAS batch, widths 256/128/40;
    sbm-products-mid: single-cluster batch, width 128, the only width
    GCNII aggregates; sbm-reddit-mid: GraphSAGE's widths 602 and 1024,
    binarized); the fused kernel B on both tables of each batch's
    loader-built hybrid pair; and the batches of phase 8 (``ppi_val``: the
    inductive val graph)."""
    arxiv = kernel_cases(device, "sbm-arxiv", 80, 40, 256, (256, 128, 40), True,
                         (("fwd", 256), ("fwd", 128), ("fwd", 40), ("bwd", 256),
                          ("bwd", 40)))
    prod = kernel_cases(device, "sbm-products-mid", 30, 1, 128, (128,), False,
                        (("fwd", 128), ("bwd", 128)))
    reddit = reddit_cases(device)
    gat = {"ell_spmm": gat_cases(device)}
    pna = pna_cases(device)
    new = phase8_cases(device, ppi_val)
    evals = {"block_spmm": eval_block_cases(device)}
    return {k: arxiv.get(k, []) + prod.get(k, []) + reddit.get(k, []) + gat.get(k, [])
            + pna.get(k, []) + new.get(k, []) + evals.get(k, []) for k in KERNELS}


def phase8_cases(device, ppi_val, d: int = 1024) -> list:
    """Phase 2 on the new batch shapes of phase 8, binarized as GraphSAGE
    aggregates them, at D1024: the inductive full forward's whole-graph
    batch of the ``ppi`` val graph as GraphSAGE's ``ppi`` full forward
    collates it (``ptr = [0, n]``, ``block-fwd`` with the dense tier's cost
    model at D1024): kernel A on its tiles where the tier takes part of it,
    the fused kernel B on the rest, and then the fused kernel B on the
    whole graph (``hybrid-fwd``, the batch of the hybrid eval format); and
    the fused kernel B on both tables
    of one ``ns`` training batch of ``sbm-reddit-mid`` (25 neighbors a row,
    the first batch of epoch 0).  Returns the cases by kernel."""
    import numpy as np

    from incagg_gnn_tpu_torch.graph.csr import gcn_norm, permute
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.graph.partition import partition_graph
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader, SubgraphLoader
    from incagg_gnn_tpu_torch.ops import kernels as K

    gen = torch.Generator(device=device).manual_seed(8)
    g = dataclasses.replace(ppi_val, adj_t=gcn_norm(ppi_val.adj_t.set_diag()))
    whole = EvalSubgraphLoader(g, np.array([0, g.num_nodes]), "cpu",
                               adj_format="block-fwd", block_d_hint=d)
    adj = whole._collate(np.array([0])).device.adj.to(device).binarized()
    x_rows = whole.buckets.cols
    out = []
    if hasattr(adj, "dense"):  # the dense tier took part of the graph
        x = torch.randn(x_rows, d, generator=gen, device=device)
        dense, rows = adj.dense, adj.num_rows
        res = compare(f"ppi val whole-graph batch A fwd rb{dense.rb} f32 binarized D{d} "
                      f"({dense.vals.numel()} entries)",
                      lambda: K.block_spmm(dense, x, rows),
                      lambda: K.block_spmm_reference(dense, x, rows),
                      block_cost(dense, x, rows),
                      lambda csr=tiles_csr(dense, rows, x_rows): torch.sparse.mm(csr, x))
        res["main"] = False
        out.append(("block_spmm", res))
        del x
    tables = [("ppi val whole-graph batch fwd" + (" remainder" if hasattr(adj, "dense")
                                                  else ""),
               getattr(adj, "rem", adj), x_rows)]
    if hasattr(adj, "dense"):  # and the whole graph as kernel B alone takes it
        hyb = EvalSubgraphLoader(g, np.array([0, g.num_nodes]), "cpu",
                                 adj_format="hybrid-fwd")
        tables.append(("ppi val whole-graph batch hybrid-fwd",
                       hyb._collate(np.array([0])).device.adj.to(device).binarized(),
                       hyb.buckets.cols))

    data, _, _ = get_data("", "sbm-reddit-mid")
    perm, ptr = partition_graph(data.adj_t, 20, seed=42)
    data = permute(data, perm)
    data.adj_t = gcn_norm(data.adj_t.set_diag())
    ns = SubgraphLoader(data, ptr, "cpu", batch_size=1, mode="ns", num_neighbors=25,
                        shuffle=True, seed=42, adj_format="hybrid")
    first = ns._groups(shuffled=True, epoch=0)[0]
    hb = ns._collate(first, 0, 0)
    if not hb.num_edges <= hb.batch_size * 25:
        raise AssertionError(f"ns batch: {hb.num_edges} edges over {hb.batch_size} x 25")
    pair = hb.device.adj.to(device).binarized()
    tables += [("sbm-reddit-mid ns batch fwd", pair.fwd, pair.bwd.num_rows),
               ("sbm-reddit-mid ns batch bwd", pair.bwd, pair.fwd.num_rows)]
    for tag, h, x_rows in tables:
        x = torch.randn(x_rows, d, generator=gen, device=device)
        tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
        csr = hybrid_csr(h, x_rows)
        res = compare(f"{tag} {tuple(h.ell_cols.shape)} +{int(h.ovf_ptr[-1])} tail, "
                      f"binarized, D{d}: fused",
                      lambda h=h, x=x, tail=tail: K.hybrid_spmm(h.ell_cols, h.ell_vals,
                                                                *tail, x),
                      lambda h=h, x=x, tail=tail: K.hybrid_spmm_reference(
                          h.ell_cols, h.ell_vals, *tail, x),
                      hybrid_cost(h, x), lambda csr=csr, x=x: torch.sparse.mm(csr, x),
                      gathered=hybrid_real(h) * d * 4)
        res["main"] = False
        out.append(("ell_spmm", res))
        del x, csr
    del tables, pair, adj
    torch.cuda.empty_cache()
    return {k: [r for name, r in out if name == k] for k in ("block_spmm", "ell_spmm")}


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

def run_counted(argv) -> tuple:
    """The CLI entry point in-process, the launch counters reset first:
    its result, the counters, its wall seconds and peak device memory."""
    from incagg_gnn_tpu_torch.__main__ import main
    from incagg_gnn_tpu_torch.ops import kernels as K

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTERS:
        getattr(K, name).launches = 0
    t = time.perf_counter()
    res = main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (res, {name: getattr(K, name).launches for name in COUNTERS}, wall,
            torch.cuda.max_memory_allocated())


def run_slice(yaml: str, dataset: str, fmt: str, vr: bool, extra=()) -> dict:
    """The CLI entry point, in-process, counters reset first.  Block runs
    must launch kernels A and B in the fill, train and eval phases; hybrid
    runs kernel B (they hold no dense tiles).  ``fmt="coo"`` is a run with
    ``adj_format=auto`` and edge dropout (``extra``): it must train on the
    COO format, launching no kernel in the train phase, and launch kernel B
    in the fill and eval (its refresh takes the dense tier or hybrid).
    ``fmt="coo-only"`` is a run with ``adj_format=coo``: training and
    refresh on the COO format, no kernel launched.  GAT's hybrid runs must
    launch kernel B's heads form in every phase.  Every launch of kernel B
    must be fused with its overflow tail.  PNA's hybrid runs must launch the
    max form in every phase and its backward in training only.  A launch
    of the ELL core alone
    would mean an extension level or the incidence path, which the
    loader's static buckets never build."""
    adj_format = {"coo": "auto", "coo-only": "coo"}.get(fmt, fmt)
    argv = ["--model", yaml, "--dataset", dataset, f"adj_format={adj_format}",
            "epochs=1", f"vr_update={'true' if vr else 'false'}", *extra]
    res, counts, wall, peak = run_counted(argv)
    tag = (f"{os.path.basename(yaml)} {dataset} {fmt} {'VR' if vr else 'GAS'}"
           f"{' ' + ' '.join(extra) if extra else ''}")

    ep = res["epochs"][0]
    nums = [ep["loss"], ep["train_acc"], ep["val_acc"], ep["test_acc"],
            res["fill"]["train_acc"]]
    if not all(math.isfinite(v) for v in nums):
        raise AssertionError(f"{tag}: non-finite loss/accuracy {nums}")
    if ep["steps"] < 1:
        raise AssertionError(f"{tag}: no training step ran")
    required = ("ell_spmm", "hybrid_spmm")
    if fmt == "block":
        required = ("block_spmm",) + required
    # a refresh over global-column batches aggregates by the storage-dtype
    # form of kernel B alone; training keeps the loader's batch-local pair
    eval_required = ("hybrid_spmm_table",) if res["global_cols"] else None
    if os.path.basename(yaml) == "gat.yaml" and fmt == "hybrid":
        required += ("hybrid_spmm_heads",)
    pna = os.path.basename(yaml) == "pna.yaml" and fmt == "hybrid"
    if pna:
        required += ("hybrid_max",)
    if fmt == "coo-only":
        required = ()
        if res["formats"] != ("coo", "coo") or any(counts.values()):
            raise AssertionError(f"{tag}: formats {res['formats']}, launches {counts}; "
                                 f"a COO run launches no kernel")
    if fmt == "block" and res["dense_tiles"] <= 0:
        raise AssertionError(f"{tag}: no dense tile with an edge: the block "
                             f"tier did not engage")
    if fmt == "coo" and res["formats"][0] != "coo":
        raise AssertionError(f"{tag}: trained on {res['formats'][0]}, not COO")
    prev = dict.fromkeys(COUNTERS, 0)
    for phase in ("fill", "train0", "eval0"):
        now = res["launches"][phase]
        if fmt == "coo" and phase == "train0":
            if now != prev:
                raise AssertionError(f"{tag}: a kernel launched in COO training")
            continue
        for k in (required if phase == "train0" or eval_required is None
                  else eval_required):
            if now[k] <= prev[k]:
                raise AssertionError(f"{tag}: kernel {k} not launched in phase {phase}")
        if pna and (now["hybrid_max_bwd"] > prev["hybrid_max_bwd"]) != (phase == "train0"):
            raise AssertionError(f"{tag}: the max form's backward must run in training "
                                 f"and only there (phase {phase})")
        prev = now
    if counts["ell_spmm"] != counts["hybrid_spmm"]:
        raise AssertionError(f"{tag}: {counts['ell_spmm'] - counts['hybrid_spmm']} "
                             f"launches of kernel B without the fused tail")
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"  {tag}: loss {ep['loss']:.4f} train {ep['train_acc']:.4f} "
        f"val {ep['val_acc']:.4f} test {ep['test_acc']:.4f} steps {ep['steps']}")
    log(f"  {tag}: formats (train, eval) {res['formats']}; global-column refresh "
        f"{res['global_cols']}; epoch 0 {'fused' if ep['fused'] else 'loop: ' + ep['reason']}"
        f"; dense tiles (eval batches, non-empty) {res['dense_tiles']}; "
        f"cumulative launches after each phase {json.dumps(res['launches'])}")
    log(f"  {tag}: seconds " + json.dumps({k: round(v, 3) for k, v in res['phases'].items()})
        + f" wall {wall:.3f}; max_memory_allocated {peak} bytes; host peak "
        f"RSS of the process so far {host_peak} bytes")
    return {"counts": counts, "phases": res["phases"], "peak_bytes": peak,
            "loss": ep["loss"], "val": ep["val_acc"], "spill_bytes": res["spill_bytes"]}


def check_spill(device_run: dict, spill_run: dict, tag: str, cache_bytes=None) -> None:
    """Phase 6 (a): a ``--spill`` run against the device-cache run of the
    same configuration, format and mode; with ``cache_bytes``, its peak
    device memory must lie below that run's by 0.8 times them."""
    lo, ls = device_run["loss"], spill_run["loss"]
    if not abs(ls - lo) <= 1e-5 * abs(lo):
        raise AssertionError(f"{tag}: spill loss {ls!r} vs device-cache {lo!r}")
    if not abs(spill_run["val"] - device_run["val"]) <= 1e-4:
        raise AssertionError(f"{tag}: spill val {spill_run['val']} vs device-cache "
                             f"{device_run['val']}")
    saved = device_run["peak_bytes"] - spill_run["peak_bytes"]
    if cache_bytes is not None and saved < 0.8 * cache_bytes:
        raise AssertionError(f"{tag}: the spill run's peak device memory is only "
                             f"{saved} bytes below the device-cache run's; the "
                             f"caches hold {cache_bytes}")
    staged, prev = {}, {"h2d": 0, "d2h": 0}
    for phase, now in spill_run["spill_bytes"].items():
        staged[phase] = {k: now[k] - prev[k] for k in now}
        prev = now
    log(f"  {tag}: loss {ls!r} (device-cache {lo!r}), val {spill_run['val']:.4f} "
        f"(device-cache {device_run['val']:.4f}); peak device memory "
        f"{spill_run['peak_bytes']} vs {device_run['peak_bytes']} bytes, {saved} "
        f"lower, the caches {cache_bytes}; bytes staged per phase {json.dumps(staged)}")


def _cli(args, env=None, log_name=None) -> str:
    """Run the port's CLI as a child process; its output goes to
    ``build/<log_name>``; returns it, raising if the run failed."""
    proc = subprocess.run([sys.executable, "-m", "incagg_gnn_tpu_torch", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env={**os.environ, **(env or {})})
    out = proc.stdout + proc.stderr
    if log_name:
        with open(os.path.join(ROOT, "build", log_name), "w") as f:
            f.write(out)
    if proc.returncode != 0:
        raise AssertionError(f"CLI {' '.join(args)} exited {proc.returncode}:\n"
                             f"{out[-3000:]}")
    return out


def _records(path: str, kind: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def check_checkpoint_supervise() -> None:
    """Phase 6 (b): checkpoint, supervised restart and eval-only of GCN at
    the arxiv configuration on sbm-arxiv, hybrid GAS, two epochs."""
    import shutil

    import numpy as np

    from incagg_gnn_tpu_torch.graph.datasets import get_data

    work = os.path.join(ROOT, "build", "phase6")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = ["--model", GCN_YAML, "--dataset", "arxiv", "dataset=sbm-arxiv",
            "adj_format=hybrid", "epochs=2"]
    try:
        t = time.perf_counter()
        ref_m = os.path.join(work, "ref.jsonl")
        _cli(base + ["--checkpoint-dir", os.path.join(work, "ref"),
                     f"metrics_path={ref_m}"], log_name="phase6_ref.log")
        shutil.rmtree(os.path.join(work, "ref"))  # 1 GB a checkpoint
        log(f"  uninterrupted run: {time.perf_counter() - t:.1f} s")

        t = time.perf_counter()
        ck = os.path.join(work, "sup")
        sup_m = os.path.join(work, "sup.jsonl")
        out = _cli(base + ["--supervise", "2", "--checkpoint-dir", ck,
                           "device_timeout_s=120", f"metrics_path={sup_m}"],
                   env={"INCAGG_FAULT_INJECT": "epoch=1"}, log_name="phase6_sup.log")
        restarts = out.count("restarting from checkpoint epoch 0")
        if restarts != 1 or "resumed from checkpoint epoch 0" not in out:
            raise AssertionError(f"supervised run: {restarts} restarts from epoch 0:\n"
                                 f"{out[-3000:]}")
        for line in out.splitlines():
            if "supervisor:" in line or "device loss" in line or "resumed" in line:
                log("    " + line)
        ref_tr, sup_tr = _records(ref_m, "train_epoch"), _records(sup_m, "train_epoch")
        ref_ev, sup_ev = _records(ref_m, "eval"), _records(sup_m, "eval")
        # the first child logged the fill and epochs 0 and 1, the restarted
        # one its fill and epoch 1 again
        lr, ls = ref_tr[1]["loss"], sup_tr[-1]["loss"]
        vr_, vs = ref_ev[-1]["val_acc"], sup_ev[-1]["val_acc"]
        log(f"  supervised run: {time.perf_counter() - t:.1f} s; epoch 1 loss {ls!r} "
            f"(uninterrupted {lr!r}, {'bit for bit' if ls == lr else 'differs'}), "
            f"val {vs} (uninterrupted {vr_})")
        if not (abs(ls - lr) <= 1e-5 * abs(lr) and abs(vs - vr_) <= 1e-4):
            raise AssertionError(f"resumed epoch 1: loss {ls} val {vs}; uninterrupted "
                                 f"loss {lr} val {vr_}")

        t = time.perf_counter()
        ev_m = os.path.join(work, "eval.jsonl")
        logits_path = os.path.join(work, "logits.npy")
        _cli(base + ["--checkpoint-dir", ck, "--eval-only", "--save-logits", logits_path,
                     f"metrics_path={ev_m}"], log_name="phase6_eval.log")
        ev = _records(ev_m, "eval")[-1]
        last = sup_ev[-1]
        for key in ("val_acc", "test_acc"):
            if not abs(ev[key] - last[key]) <= 1e-4:
                raise AssertionError(f"eval-only {key} {ev[key]} vs the last eval's "
                                     f"{last[key]}")
        data, _, out_c = get_data("/tmp/datasets", "sbm-arxiv")
        logits = np.load(logits_path)
        if logits.shape != (data.num_nodes, out_c) or not np.isfinite(logits).all():
            raise AssertionError(f"logits {logits.shape}, want ({data.num_nodes}, {out_c})")
        pred = logits.argmax(1)
        acc = float((pred[data.val_mask] == data.y[data.val_mask]).mean())
        if not abs(acc - ev["val_acc"]) < 1e-6:
            raise AssertionError(f"logits in the original order give val {acc}, the "
                                 f"eval-only run reported {ev['val_acc']}")
        log(f"  eval-only: {time.perf_counter() - t:.1f} s; val {ev['val_acc']} test "
            f"{ev['test_acc']} (last eval {last['val_acc']} {last['test_acc']}); logits "
            f"{logits.shape} in the original order (val from them {acc})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def make_each_graph_once() -> None:
    """The phases drive the same synthetic graphs many times, and making
    one takes up to 20 s (``sbm-products-mid``): keep each graph the
    dataset module makes for the rest of the process.  Every user permutes
    a copy and leaves the graph it was given as it is."""
    from incagg_gnn_tpu_torch.graph import datasets

    made, make = {}, datasets.get_data

    def get_data(root, name, **kwargs):
        key = (name.lower(), tuple(sorted(kwargs.items())))
        if key not in made:
            made[key] = make(root, name, **kwargs)
        return made[key]

    datasets.get_data = get_data


def check_small_reference() -> None:
    """Phase 3: the CUDA run agrees with the CPU run (plain versions) on
    sbm-small, same seed, dropout 0, GCN, GCNII, GraphSAGE and APPNP on the
    block format, GAT and PNA on the hybrid pair (kernel B's heads form and
    max form on the card)."""
    from incagg_gnn_tpu_torch.__main__ import main

    for yaml in (GCN_YAML, GCN2_YAML, SAGE_YAML, APPNP_YAML, GAT_YAML, PNA_YAML):
        fmt = "hybrid" if yaml in (GAT_YAML, PNA_YAML) else "block"
        for vr in ("false", "true"):
            tag = f"{os.path.basename(yaml)} sbm-small {fmt} vr={vr}"
            argv = ["--model", yaml, "--dataset", "sbm-small", f"adj_format={fmt}",
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


def check_accuracy(device, dataset: str = "sbm-products-hard-v4", epochs: int = 20,
                   within: float = 0.02) -> None:
    """Phase 5: one run of GCN GAS with the accuracy suite's protocol (16
    parts, 4 clusters a batch, hidden 64, lr 0.01, dataset and trainer
    seed 0); the test accuracy at the best validation epoch must lie within
    ``within`` of the JAX package's mean for the row."""
    from incagg_gnn_tpu_torch.accuracy_suite import run_row

    with open(ACCURACY_REF) as f:
        ref = json.load(f)["results"][f"{dataset}/gcn-gas"]
    acc = run_row(dataset, "gcn", False, 1, epochs, "float32", device)[0]
    log(f"  {dataset} gcn-gas, 1 run x {epochs} epochs: test {acc:.4f}; JAX package "
        f"{ref['mean']:.4f} +- {ref['std']:.4f} over {len(ref['runs'])} runs")
    if not abs(acc - ref["mean"]) <= within:
        raise AssertionError(f"GCN GAS on {dataset}: test accuracy {acc:.4f} is not "
                             f"within {within} of the JAX package's {ref['mean']:.4f}")


# ---------------------------------------------------------------------------
# phase 7: the fused epoch and the global-column refresh
# ---------------------------------------------------------------------------

def make_trainer(yaml: str, dataset: str, overrides=(), device="cuda"):
    """A trainer on the card as the CLI builds it, and the run config."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    run_cfg = load_config(yaml, dataset, parse_overrides(list(overrides)))
    data, in_c, out_c = get_data("/tmp/datasets", run_cfg.dataset)
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    return Trainer(model, data, run_cfg.trainer, device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def _caches(tr) -> list:
    return [t.clone() for t in (*tr.hist.emb, *tr.hist.emb_ag)]


def fused_vs_loop(tag: str, tr, epochs: int, reps: int = 1) -> dict:
    """Phase 7 (a): from one filled state, ``epochs`` epochs (train, then
    refresh and eval) with ``fused_epoch=auto`` and ``off``, once each at
    dropout 0, and ``reps`` times each at the configuration's dropout (in
    the order auto, off, off, auto, ...), each epoch's train seconds with
    their spread over the repeats; the kernels' counts set to 0 before each
    run and read after it.  Returns the runs' counts, every epoch's record
    and the filled state and its logits."""
    from incagg_gnn_tpu_torch.ops import kernels as K

    fill = tr.fill_history()
    start = {k: v.clone() for k, v in tr.checkpoint_state().items()}
    cfg0 = tr.model.cfg
    order = [(0.0, "auto"), (0.0, "off")]
    if cfg0.dropout:
        order += [(cfg0.dropout, ("auto", "off", "off", "auto")[i % 4])
                  for i in range(2 * reps)]
    out, runs, train_s = {}, [], {}
    for drop, mode in order:
        tr.restore_checkpoint(start)
        tr.model.cfg = dataclasses.replace(cfg0, dropout=drop)
        tr.cfg.fused_epoch = mode
        for name in COUNTERS:
            getattr(K, name).launches = 0
        losses, vals = [], []
        for epoch in range(epochs):
            t = time.perf_counter()
            r = tr.train_epoch()
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t
            t = time.perf_counter()
            ev = tr.evaluate()
            eval_s = time.perf_counter() - t
            losses.append(r["loss"])
            vals.append(ev["val_acc"])
            path = ("fused, " + f"{r['captures']} capture(s), launches per replay "
                    + json.dumps(r["launches_per_replay"]) if r["fused"]
                    else f"loop ({r['reason']})")
            log(f"  {tag} dropout {drop} fused_epoch={mode} epoch {epoch}: {path}; "
                f"loss {r['loss']!r} val {ev['val_acc']:.4f}; train {t_train:.3f} s "
                f"eval {eval_s:.3f} s")
            out[(drop, mode, epoch)] = {"fused": r["fused"], "train_s": t_train,
                                        "eval_s": eval_s,
                                        "per_replay": r["launches_per_replay"]}
            train_s.setdefault((drop, mode, epoch), []).append(t_train)
        runs.append({"counts": {name: getattr(K, name).launches for name in COUNTERS}})
        out[(drop, mode)] = {"losses": losses, "vals": vals,
                             "caches": _caches(tr) if drop == 0.0 else None}
    tr.model.cfg = cfg0
    fused = [e for e in range(epochs) if out[(0.0, "auto", e)]["fused"]]
    if not fused:
        raise AssertionError(f"{tag}: no epoch trained fused")
    for e in fused if tr.device.type == "cuda" else ():  # the CPU replays nothing
        per = out[(0.0, "auto", e)]["per_replay"]
        if not per.get("hybrid_spmm") and not per.get("block_spmm"):
            raise AssertionError(f"{tag}: a replay launched none of the kernels: {per}")
    a, b = out[(0.0, "auto")], out[(0.0, "off")]
    for e, (la, lb) in enumerate(zip(a["losses"], b["losses"])):
        if not abs(la - lb) <= 1e-6 * abs(lb):
            raise AssertionError(f"{tag}: epoch {e} loss fused {la!r}, loop {lb!r}")
    worst = max(_rel(x, y) for x, y in zip(a["caches"], b["caches"]))
    if not worst <= 1e-6:
        raise AssertionError(f"{tag}: caches fused vs loop {worst:.3e} relative")
    log(f"  {tag}: at dropout 0 the fused run's losses {a['losses']} equal the loop's "
        f"{b['losses']} within 1e-6 (caches {worst:.2e} relative); fused epochs {fused}")
    if cfg0.dropout:
        log(f"  {tag}: at dropout {cfg0.dropout}: fused losses "
            f"{out[(cfg0.dropout, 'auto')]['losses']}, loop "
            f"{out[(cfg0.dropout, 'off')]['losses']}")
        for e in range(epochs):
            cells = []
            for mode in ("auto", "off"):
                ts = train_s[(cfg0.dropout, mode, e)]
                cells.append(f"{mode} median {statistics.median(ts):.3f} s (min "
                             f"{min(ts):.3f}, max {max(ts):.3f}, n {len(ts)})")
            log(f"  {tag}: dropout {cfg0.dropout} epoch {e} train: " + "; ".join(cells))
    return {"runs": runs, "epochs": out, "start": start, "fill": fill}


def fused_resume(tag: str, tr, start: dict, make, save_after: int) -> None:
    """Phase 7 (d): resume across a fused epoch.  From ``start``, at the
    configuration's dropout, epochs ``0..save_after`` (epoch ``save_after``
    fused) and a checkpoint through ``CheckpointManager``, then one more
    epoch; a fresh trainer (``make()``) restores the checkpoint, fills its
    caches as the CLI does and trains the same epoch, which must be fused
    and equal the uninterrupted one bit for bit: loss, parameters, Adam
    state, generator, caches and logits."""
    import shutil

    from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager

    ckdir = os.path.join(ROOT, "build", "phase7_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = CheckpointManager(ckdir)
    tr.restore_checkpoint(start)
    tr.cfg.fused_epoch = "auto"
    for epoch in range(save_after + 1):
        r = tr.train_epoch()
        tr.evaluate()
    if not r["fused"]:
        raise AssertionError(f"{tag}: epoch {save_after} did not train fused: {r['reason']}")
    ckpt.save(tr, save_after)
    want = tr.train_epoch()
    tr.evaluate()
    t = time.perf_counter()
    fresh = make()
    fresh.cfg.fused_epoch = "auto"
    if not ckpt.maybe_restore(fresh):
        raise AssertionError(f"{tag}: no checkpoint restored")
    fresh.fill_history()
    got = fresh.train_epoch()
    fresh.evaluate()
    if not (got["fused"] and want["fused"]):
        raise AssertionError(f"{tag}: resumed epoch fused {got['fused']} "
                             f"({got['reason']}), uninterrupted {want['fused']}")
    if got["loss"] != want["loss"]:
        raise AssertionError(f"{tag}: resumed loss {got['loss']!r}, "
                             f"uninterrupted {want['loss']!r}")
    a, b = tr.checkpoint_state(), fresh.checkpoint_state()
    differ = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
    if not torch.equal(tr.out_table, fresh.out_table):
        differ.append("logits")
    if differ:
        raise AssertionError(f"{tag}: resumed state differs from the uninterrupted "
                             f"one in {differ}")
    log(f"  {tag}: resumed from a checkpoint after fused epoch {save_after} in a fresh "
        f"trainer [{time.perf_counter() - t:.1f} s]: epoch {save_after + 1} fused, loss "
        f"{got['loss']!r}, and all {len(a)} state tensors and the logits bit for bit "
        "the uninterrupted run's")
    del fresh
    shutil.rmtree(ckdir, ignore_errors=True)


#: the kernels a fused step launches, by wrapper counter and kernel name
REPLAYED = {"block_spmm": ("block_spmm_kernel",),
            "ell_spmm": ("ell_spmm_vec_kernel", "ell_spmm_scalar_kernel",
                         "ell_spmm_heads_"),
            "hybrid_max": ("hybrid_max_vec_kernel", "hybrid_max_scalar_kernel"),
            "hybrid_max_bwd": ("hybrid_max_bwd_vec_kernel", "hybrid_max_bwd_scalar_kernel")}
#: the max form's backward also launches this once a column chunk
BWD_STEP = "max_bwd_step_kernel"


def raw_by_replay(prof, pats) -> dict:
    """For a failed count: the profiler's raw device records whose name
    holds one of ``pats``, by the ``cudaGraphLaunch`` they correlate with
    (how many launches hold how many such records), and those outside any
    replay."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    launches = {e.correlation_id() for e in raw if e.name() == "cudaGraphLaunch"}
    per, outside = {c: 0 for c in launches}, 0
    for e in raw:
        if e.device_type() == DeviceType.CUDA and any(p in e.name() for p in pats):
            if e.correlation_id() in per:
                per[e.correlation_id()] += 1
            else:
                outside += 1
    return {"replays_by_count": dict(collections.Counter(per.values())),
            "outside": outside}


def graph_kernel_nodes(graph) -> collections.Counter:
    """The kernel nodes of a captured CUDA graph, by kernel name (as
    ``libcuda`` names the function), read through ``libcuda``: the graph's
    nodes (``cuGraphGetNodes``), their types (``cuGraphNodeGetType``,
    child graphs walked), and each kernel node's function
    (``cuGraphKernelNodeGetParams``) and name (``cuFuncGetName``).
    ``graph`` is a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True``."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    kernel, child = 0, 4  # CU_GRAPH_NODE_TYPE_KERNEL, CU_GRAPH_NODE_TYPE_GRAPH

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn}: CUresult {rc}")

    names = collections.Counter()

    def walk(g):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", ctypes.c_void_p(g), None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", ctypes.c_void_p(g), nodes, ctypes.byref(n))
        for node in nodes:
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
            if kind.value == child:
                sub = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", ctypes.c_void_p(node), ctypes.byref(sub))
                walk(sub.value)
            elif kind.value == kernel:
                p = Params()
                call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(p))
                name = ctypes.c_char_p()
                if p.func:
                    call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(p.func))
                else:
                    call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(p.kern))
                names[name.value.decode()] += 1

    walk(graph.raw_cuda_graph())
    return names


def replay_launches(tag: str, tr) -> dict:
    """Phase 7 (e): an epoch of ``tr`` that captures its step anew (the
    width of every max-form backward call in the capture recorded), then
    one under ``torch.profiler`` in which every batch is a replay.  The
    kernels the card ran, counted by name, must equal the counters'
    increase (which a replay makes with ``add_launches``) and the replays
    times the launches per replay; ``max_bwd_step_kernel`` must run
    ceil(D / chunk) times for each backward call of width D (the vector
    path's plan, its chunk read from the library)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from incagg_gnn_tpu_torch.ops import ell as E
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.train import steps as S

    try:
        torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        raise AssertionError(f"{tag}: torch {torch.__version__} cannot keep a captured "
                             f"graph (CUDAGraph(keep_graph=True): {e}), so its kernel "
                             f"nodes cannot be counted") from e
    widths, real_bwd = [], E.hybrid_max_bwd

    def recording_bwd(*args):
        dx = real_bwd(*args)
        if torch.cuda.is_current_stream_capturing():
            widths.append(int(dx.shape[1]))
        return dx

    tr.cfg.fused_epoch = "auto"
    tr._fused_fn = None  # capture the step again, with the widths recorded
    E.hybrid_max_bwd = recording_bwd
    S.EpochGraph.keep_graph = True  # the captured graph's nodes: the second count
    try:
        tr.train_epoch()
    finally:
        E.hybrid_max_bwd = real_bwd
        S.EpochGraph.keep_graph = False
    graph = tr._fused_fn
    captures = graph.captures
    nodes = graph_kernel_nodes(graph._graph)
    before = K.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = tr.train_epoch()
        torch.cuda.synchronize()
    if not r["fused"] or tr._fused_fn is not graph or graph.captures != captures:
        raise AssertionError(f"{tag}: the profiled epoch did not only replay: {r['reason']}")
    counted = {k: v - before[k] for k, v in K.launch_counts().items()}
    per = r["launches_per_replay"]
    replays = counted["ell_spmm"] // max(per.get("ell_spmm", 0), 1)
    seen = dict.fromkeys(REPLAYED, 0)
    steps_seen = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            for name, pats in REPLAYED.items():
                seen[name] += any(p in evt.name for p in pats)
            steps_seen += BWD_STEP in evt.name
    for name in REPLAYED:
        if not seen[name] == counted[name] == replays * per.get(name, 0):
            raise AssertionError(
                f"{tag}: {name} ran {seen[name]} times under the profiler, counted "
                f"{counted[name]}, {replays} replays x {per.get(name, 0)}; the raw "
                f"records by replay: {raw_by_replay(prof, REPLAYED[name])}")
    if captures != 1 or len(widths) != per.get("hybrid_max_bwd", 0):
        raise AssertionError(f"{tag}: {captures} captures recorded backward widths "
                             f"{widths}, {per.get('hybrid_max_bwd', 0)} calls a replay")
    chunk = K.hybrid_max_chunk_cols()["hybrid_max_bwd"]
    steps_per = sum(-(-d // chunk) for d in widths if d % 4 == 0)
    if steps_seen != replays * steps_per:
        raise AssertionError(f"{tag}: {BWD_STEP} ran {steps_seen} times under the "
                             f"profiler, {replays} replays x {steps_per} (widths {widths})")
    # the second, independent count: the kernel nodes of the captured graph
    in_graph = {name: sum(n for k, n in nodes.items() if any(p in k for p in pats))
                for name, pats in REPLAYED.items()}
    step_nodes = sum(n for k, n in nodes.items() if BWD_STEP in k)
    for name in REPLAYED:
        if not in_graph[name] == per.get(name, 0) or replays * in_graph[name] != counted[name]:
            raise AssertionError(
                f"{tag}: the captured graph holds {in_graph[name]} {name} kernel nodes; "
                f"{per.get(name, 0)} launches a replay, {counted[name]} counted over "
                f"{replays} replays")
    if step_nodes != steps_per:
        raise AssertionError(f"{tag}: the captured graph holds {step_nodes} {BWD_STEP} "
                             f"nodes, {steps_per} expected (widths {widths})")
    log(f"  {tag}: a fused epoch of {replays} replays under torch.profiler: kernels "
        f"run {json.dumps(seen)}, equal to the counters and to {replays} x "
        f"{json.dumps(per)}; {BWD_STEP} {steps_seen} = {replays} x {steps_per} "
        f"(backward widths {widths}, {chunk}-column chunks); the captured graph's "
        f"{sum(nodes.values())} kernel nodes hold {json.dumps(in_graph)} and "
        f"{step_nodes} {BWD_STEP}, the same per replay")
    return {"case": tag, "replays": replays, "seen": seen, "per_replay": per,
            "graph_nodes": in_graph, "graph_kernel_nodes": sum(nodes.values()),
            "bwd_widths": widths, "bwd_steps_seen": steps_seen,
            "bwd_steps_per_replay": steps_per}


def global_vs_local(tag: str, tr) -> dict:
    """Phase 7 (b): on the trainer's state, the refresh over its eval
    loader's global-column batches against one over batch-local batches of
    the same clusters: logits and caches within 1e-5 of their largest
    value; both refreshes timed and their kernel launches counted."""
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader
    from incagg_gnn_tpu_torch.ops import kernels as K

    glob = tr.eval_loader
    local = EvalSubgraphLoader(tr.data, tr.ptr, tr.device,
                               batch_size=tr.cfg.eval_batch_size,
                               adj_format=glob.adj_format)
    local.hbm_budget = glob.hbm_budget
    res = {}
    for name, loader in (("global", glob), ("batch-local", local)):
        tr.eval_loader = loader
        loader.cached()  # collate outside the timed refresh
        before = K.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr._refresh(host_logits=False)
        torch.cuda.synchronize()
        res[name] = {"s": time.perf_counter() - t, "out": tr.out_table.clone(),
                     "caches": _caches(tr),
                     "launches": {k: v - before[k] for k, v in K.launch_counts().items()
                                  if v != before[k]},
                     "plan": dict(tr.model._last_refresh_plan)}
    tr.eval_loader = glob
    g, l = res["global"], res["batch-local"]
    if not g["plan"]["global_cols"] or l["plan"]["global_cols"]:
        raise AssertionError(f"{tag}: plans {g['plan']} {l['plan']}")
    worst = max(_rel(x, y) for x, y in zip([g["out"], *g["caches"]],
                                           [l["out"], *l["caches"]]))
    if not worst <= 1e-5:
        raise AssertionError(f"{tag}: global vs batch-local refresh {worst:.3e} relative")
    log(f"  {tag}: refresh global {g['s']:.3f} s, launches {json.dumps(g['launches'])}; "
        f"batch-local {l['s']:.3f} s, launches {json.dumps(l['launches'])}; logits and "
        f"caches within {worst:.2e} of their largest value")
    del local
    return {"global_s": g["s"], "local_s": l["s"],
            "per_refresh": g["launches"].get("hybrid_spmm_table", 0)}


def table_cases(tag: str, tr, per_refresh: int) -> list:
    """Phase 7 (c): kernel B's storage-dtype form on the trainer's first
    global-column eval batch, the layer-1 cache as the table in f32, bf16
    and both fp8 types, against its plain version; cuSPARSE on the same
    batch in f32 (it takes no f32 values over bf16 or fp8 rows)."""
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.profile_agg import graph_ms

    h = tr.eval_loader.to_device(tr.eval_loader.cached()[0]).wait().device.adj
    tail = (h.ovf_ptr, h.ovf_cols, h.ovf_vals)
    n = int(h.ovf_ptr[-1])
    named = int(torch.unique(torch.cat([h.ell_cols[h.ell_vals != 0],
                                        h.ovf_cols[:n][h.ovf_vals[:n] != 0]])).numel())
    base = tr.hist.emb[1].float()
    d = int(base.shape[1])
    out = []
    for dtype in K.TABLE_ROW_TYPES:
        table = base.to(dtype)
        # the least work: the hybrid table and its real tail read once, each
        # distinct table row the real slots name once in its dtype, out once
        moved = (nbytes(h.ell_cols, h.ell_vals, h.ovf_ptr) + n * 8
                 + named * d * table.element_size() + h.num_rows * d * 4)
        cost = bound(moved, 2 * hybrid_real(h) * d)
        lib = None
        if dtype == torch.float32:
            csr = hybrid_csr(h, int(table.shape[0]))
            lib = lambda csr=csr, x=table: torch.sparse.mm(csr, x)  # noqa: E731
        name = str(dtype).split(".")[-1]
        res = compare(f"{tag} B table {name} {tuple(h.ell_cols.shape)} +{n} tail D{d} "
                      f"over {tuple(table.shape)}",
                      lambda table=table: K.hybrid_spmm_table(h.ell_cols, h.ell_vals,
                                                              *tail, table),
                      lambda table=table: K.hybrid_spmm_reference(h.ell_cols, h.ell_vals,
                                                                  *tail, table),
                      cost, lib)
        # a launch of a few microseconds: back-to-back calls time the host
        res["graph_ms"] = graph_ms(lambda table=table: K.hybrid_spmm_table(
            h.ell_cols, h.ell_vals, *tail, table))
        log(f"    as CUDA-graph replays (no host launch cost): kernel {res['graph_ms']:.4f} "
            f"ms, share of the bound {res['bound_ms'] / res['graph_ms']:.3f}")
        res.update(row_type=name, launches_per_refresh=per_refresh,
                   main=tag == "GCN arxiv hybrid GAS" and dtype == torch.float32)
        out.append(res)
        del table, lib
    return out


# ---------------------------------------------------------------------------
# phase 8: datasets on disk, the inductive (PPI) protocol, neighbor sampling
# ---------------------------------------------------------------------------

#: PyG PPI's training graph (20 graphs): nodes, labels, features, and the
#: degree at which the generator's training graph holds 1,225,660 directed
#: edges against PPI's 1,226,368 (it drops self-loops and repeated edges:
#: PPI's own mean degree, 27.31, gives 1,191,536).  The val and test graphs
#: take the generator's own size, ``num_nodes // 4``
PPI_SHAPE = dict(num_nodes=44_906, num_classes=121, num_features=50, avg_degree=28.12)


def ppi_graphs(**shape) -> dict:
    """The three ``sbm-ppi`` graphs at PyG PPI's size and shape (seed 0)."""
    from incagg_gnn_tpu_torch.graph.datasets import make_sbm_inductive

    return {s: make_sbm_inductive(split=s, **{**PPI_SHAPE, **shape})[0]
            for s in ("train", "val", "test")}


def write_ppi_raw(src: str, graphs: dict) -> None:
    """PyG PPI raw files: ``{train,valid,test}_graph.json`` node-link (each
    undirected edge once), ``_feats.npy`` and ``_labels.npy``."""
    import numpy as np

    for split, raw in (("train", "train"), ("val", "valid"), ("test", "test")):
        g = graphs[split]
        row = g.adj_t.row_indices()
        keep = row < g.adj_t.col
        links = [{"source": a, "target": b}
                 for a, b in zip(row[keep].tolist(), g.adj_t.col[keep].tolist())]
        with open(os.path.join(src, f"{raw}_graph.json"), "w") as f:
            json.dump({"directed": False, "multigraph": False, "graph": {},
                       "nodes": [{"id": i} for i in range(g.num_nodes)],
                       "links": links}, f)
        np.save(os.path.join(src, f"{raw}_feats.npy"), g.x)
        np.save(os.path.join(src, f"{raw}_labels.npy"), g.y.astype(np.int64))


def _delta(launches: dict, phase: str, before: str) -> dict:
    """Launches made between the counters of ``before`` and ``phase``."""
    return {k: v - launches[before][k] for k, v in launches[phase].items()
            if v != launches[before][k]}


def inductive_ppi(graphs: dict, card: str, epochs: int = 30) -> list:
    """Phase 8 (a): the ``ppi`` graphs written as PyG PPI raw files,
    converted by ``python -m incagg_gnn_tpu_torch.convert_dataset --format
    ppi``, then the CLI on ``--dataset ppi`` with the ``ppi`` block of
    ``graphsage.yaml`` unchanged (3 x 1024, residual, 40 parts, 10 clusters
    a batch), GAS and VR, ``epochs`` epochs.  Each inductive eval (after the
    fill and after every epoch) must launch kernel B or kernel A; the last
    epoch's val and test micro-F1 must lie above the fill's (untrained
    logits).  Thirty epochs, not two: 121 labels with two positives a node
    make every logit negative within the first epochs (micro-F1 0, below
    random logits' ~0.03) until the true class's logit rises above zero,
    which this phase's log shows at epochs 14-15."""
    import shutil

    import numpy as np

    from incagg_gnn_tpu_torch.graph.datasets import get_data

    work = os.path.join(ROOT, "build", "phase8")
    shutil.rmtree(work, ignore_errors=True)
    raw, root = os.path.join(work, "raw"), os.path.join(work, "root")
    os.makedirs(raw)
    runs = []
    try:
        t = time.perf_counter()
        write_ppi_raw(raw, graphs)
        t_raw = time.perf_counter() - t
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "incagg_gnn_tpu_torch.convert_dataset", "--format",
             "ppi", "--src", raw, "--out", os.path.join(root, "ppi", "data.npz")],
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"convert_dataset exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        t_conv = time.perf_counter() - t
        for split, g in graphs.items():
            d, _, _ = get_data(root, "ppi", split=split)
            if not all(np.array_equal(a, b) for a, b in (
                    (d.adj_t.rowptr, g.adj_t.rowptr), (d.adj_t.col, g.adj_t.col),
                    (d.x, g.x), (d.y, g.y))):
                raise AssertionError(f"the converted {split} archive differs from its graph")
        log(f"  ppi raw files {t_raw:.1f} s, converted {t_conv:.1f} s: "
            + "; ".join(f"{s} N={g.num_nodes} E={g.adj_t.nnz}" for s, g in graphs.items())
            + " " + proc.stdout.strip().replace("\n", "; "))
        for vr in (False, True):
            tag = f"graphsage.yaml ppi (converted archive) {'VR' if vr else 'GAS'}"
            res, counts, wall, peak = run_counted(
                ["--model", SAGE_YAML, "--dataset", "ppi", "--root", root,
                 f"epochs={epochs}", f"vr_update={'true' if vr else 'false'}"])
            la = res["launches"]
            per_eval = [_delta(la, "inductive_fill", "fill")] + [
                _delta(la, f"inductive{e}", f"eval{e}") for e in range(epochs)]
            for e, d in enumerate(per_eval):
                if not (d.get("hybrid_spmm", 0) or d.get("block_spmm", 0)):
                    raise AssertionError(f"{tag}: inductive eval {e} launched neither "
                                         f"kernel B nor kernel A: {d}")
            fill, last = res["fill"], res["epochs"][-1]
            if not (last["val_acc"] > fill["val_acc"] and last["test_acc"] > fill["test_acc"]):
                raise AssertionError(f"{tag}: val/test {last['val_acc']} {last['test_acc']} "
                                     f"not above the untrained fill's {fill['val_acc']} "
                                     f"{fill['test_acc']}")
            ph = res["phases"]
            log(f"  {tag} ({card}): seconds " + json.dumps({k: round(v, 3) for k, v in ph.items()})
                + f" wall {wall:.3f}; train s per epoch "
                f"{[round(ep['epoch_s'], 3) for ep in res['epochs']]}, inductive eval s "
                f"{[round(ep['inductive_s'], 3) for ep in res['epochs']]}; max_memory_allocated "
                f"{peak} bytes; formats {res['formats']}")
            log(f"  {tag}: micro-F1 fill val {fill['val_acc']:.4f} test {fill['test_acc']:.4f}"
                + "; epochs' loss, val, test " + ", ".join(
                    f"{ep['loss']:.4f} {ep['val_acc']:.4f} {ep['test_acc']:.4f}"
                    for ep in res["epochs"])
                + f"; launches per inductive eval (the fill's, the same after every "
                f"epoch: {all(d == per_eval[0] for d in per_eval)}) "
                f"{json.dumps(per_eval[0])}; run total {json.dumps(counts)}")
            runs.append({"counts": counts, "phases": ph, "peak_bytes": peak,
                         "inductive_launches": per_eval})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs


def ns_reddit(unsampled: dict, card: str, epochs: int = 2, k: int = 25) -> dict:
    """Phase 8 (b): GraphSAGE at the ``sbm-reddit-mid`` block (2 x 1024)
    through the CLI, ``adj_format=hybrid``, GAS with ``num_neighbors=k``,
    ``epochs`` epochs.  Every draw of the sampler (recorded around the
    loader's call) must hold at most rows x k edges, k a row; no batch of
    one epoch may be drawn as one of the other's; kernel B must launch in
    every training phase; every ``train_epoch`` record must say it looped
    for the ns reason.  ``unsampled``: phase 4's hybrid GAS run of the same
    configuration, whose seconds are printed beside."""
    import numpy as np

    from incagg_gnn_tpu_torch import loader as L

    draws, real = [], L.sample_neighbors

    def recording(rowptr, col, value, num_neighbors, seed=0):
        out = real(rowptr, col, value, num_neighbors, seed=seed)
        deg = np.diff(out[0])
        draws.append({"rows": int(deg.shape[0]), "edges": int(out[0][-1]),
                      "max_row": int(deg.max(initial=0)), "in_edges": int(rowptr[-1]),
                      "digest": hash(out[1].tobytes())})
        return out

    metrics = os.path.join(ROOT, "build", "phase8_ns.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    tag = f"graphsage.yaml sbm-reddit-mid hybrid GAS num_neighbors={k}"
    L.sample_neighbors = recording
    try:
        res, counts, wall, peak = run_counted(
            ["--model", SAGE_YAML, "--dataset", "sbm-reddit-mid", "adj_format=hybrid",
             f"epochs={epochs}", "vr_update=false", f"num_neighbors={k}",
             f"metrics_path={metrics}"])
    finally:
        L.sample_neighbors = real
    la = res["launches"]
    for e in range(epochs):
        d = _delta(la, f"train{e}", "fill" if e == 0 else f"eval{e - 1}")
        if not d.get("hybrid_spmm", 0) or d.get("ell_spmm") != d.get("hybrid_spmm"):
            raise AssertionError(f"{tag}: kernel B fused not launched in training "
                                 f"epoch {e}: {d}")
    per_epoch = len(draws) // epochs
    if not draws or len(draws) != per_epoch * epochs:
        raise AssertionError(f"{tag}: {len(draws)} draws over {epochs} epochs")
    for d in draws:
        if not (d["edges"] <= d["rows"] * k and d["max_row"] <= k):
            raise AssertionError(f"{tag}: a batch of {d['rows']} rows drew {d['edges']} "
                                 f"edges, {d['max_row']} in one row")
    if not any(d["edges"] < d["in_edges"] for d in draws):
        raise AssertionError(f"{tag}: the sampler dropped no edge")
    first = {d["digest"] for d in draws[:per_epoch]}
    if first & {d["digest"] for d in draws[per_epoch:]}:
        raise AssertionError(f"{tag}: a batch of epoch 1 was drawn as one of epoch 0")
    reason = "neighbor sampling re-draws every epoch"
    records = _records(metrics, "train_epoch")
    if len(records) != epochs or any(r["fused"] or r["reason"] != reason for r in records):
        raise AssertionError(f"{tag}: train_epoch records {records}")
    ph = res["phases"]
    log(f"  {tag} ({card}): seconds " + json.dumps({k_: round(v, 3) for k_, v in ph.items()})
        + f" wall {wall:.3f}; train s per epoch "
        f"{[round(r['epoch_s'], 3) for r in records]} (phase 4 unsampled hybrid GAS, one "
        f"epoch: train {unsampled['phases']['train_s']:.3f} eval "
        f"{unsampled['phases']['eval_s']:.3f}); max_memory_allocated {peak} bytes "
        f"(unsampled {unsampled['peak_bytes']})")
    log(f"  {tag}: {len(draws)} draws, {per_epoch} an epoch: edges kept "
        f"{sum(d['edges'] for d in draws)} of {sum(d['in_edges'] for d in draws)}, most in "
        f"a row {max(d['max_row'] for d in draws)}; loss "
        f"{[round(ep['loss'], 4) for ep in res['epochs']]} val "
        f"{[round(ep['val_acc'], 4) for ep in res['epochs']]}; every epoch looped: {reason}; "
        f"launches {json.dumps(counts)}")
    return {"counts": counts, "phases": ph, "peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 9: the refresh sweep as captured CUDA graphs
# ---------------------------------------------------------------------------

#: phase 9 (a): tag, YAML, block, overrides, the counters a refresh must bump
SWEEP_CONFIGS = (
    ("GCN arxiv hybrid GAS", GCN_YAML, "sbm-arxiv", ("adj_format=hybrid",),
     ("hybrid_spmm_table",)),
    ("GCN arxiv block VR", GCN_YAML, "sbm-arxiv", ("adj_format=block", "vr_update=true"),
     ("block_spmm", "ell_spmm", "hybrid_spmm")),
    ("GCNII products hybrid VR", GCN2_YAML, "sbm-products-mid",
     ("adj_format=hybrid", "vr_update=true"), ("hybrid_spmm_table",)),
    ("GAT arxiv hybrid VR", GAT_YAML, "arxiv",
     ("dataset=sbm-arxiv", "adj_format=hybrid", "vr_update=true"),
     ("ell_spmm", "hybrid_spmm", "hybrid_spmm_heads")),
    ("PNA arxiv hybrid GAS", PNA_YAML, "arxiv", ("dataset=sbm-arxiv", "adj_format=hybrid"),
     ("ell_spmm", "hybrid_spmm", "hybrid_max")),
    ("APPNP arxiv hybrid GAS", APPNP_YAML, "arxiv", ("dataset=sbm-arxiv", "adj_format=hybrid"),
     ("hybrid_spmm_table",)))
#: a captured graph's kernel nodes, by a part of their names, for each count
#: of launches they answer to (kernel B's storage-dtype form is kernel B's
#: fused kernel templated on the row type: its nodes carry kernel B's names)
NODE_NAMES = {"block_spmm": ("block_spmm_kernel",),
              "kernel B": ("ell_spmm_vec_kernel", "ell_spmm_scalar_kernel", "ell_spmm_heads_"),
              "hybrid_spmm_heads": ("ell_spmm_heads_",),
              "hybrid_max": ("hybrid_max_vec_kernel", "hybrid_max_scalar_kernel")}


def nodes_by_counter(nodes: collections.Counter, per: dict) -> tuple:
    """The kernel nodes of a captured refresh by ``NODE_NAMES``, and what
    its launches per replay say they must be."""
    got = {k: sum(n for name, n in nodes.items() if any(p in name for p in pats))
           for k, pats in NODE_NAMES.items()}
    want = {"block_spmm": per.get("block_spmm", 0),
            "kernel B": per.get("ell_spmm", 0) + per.get("hybrid_spmm_table", 0),
            "hybrid_spmm_heads": per.get("hybrid_spmm_heads", 0),
            "hybrid_max": per.get("hybrid_max", 0)}
    return got, want


def refresh_state(tr) -> list:
    return [tr.out_table.clone(), *_caches(tr)]


@torch.no_grad()
def set_state(tr, state: list) -> None:
    for dst, src in zip((tr.out_table, *tr.hist.emb, *tr.hist.emb_ag), state):
        dst.copy_(src)


def peak_mark():
    """Device memory allocated from now on: a function that returns the
    peak since this call over what was allocated at it (the checks' copies
    between two refreshes are outside every window)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    return lambda: torch.cuda.max_memory_allocated() - base


def sweep_s(tr, scan: bool, subset=None) -> float:
    """One refresh of the trainer's state through ``model.refresh``, its
    wall seconds ending in a device sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.model.refresh(tr.tables.x, tr.eval_loader, tr.hist, tr.out_table,
                     vr=tr.cfg.vr_update, use_aggregation=tr.cfg.use_aggregation,
                     scan=scan, subset=subset, host_logits=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def same_state(tag: str, got: list, want: list) -> float:
    """0.0 when ``got`` equals ``want`` bit for bit; else the largest
    difference over the largest value, which must be at most 1e-6."""
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return 0.0
    worst = max(_rel(a, b) for a, b in zip(got, want))
    if not worst <= 1e-6:
        raise AssertionError(f"{tag}: captured refresh vs eager {worst:.3e} relative")
    return worst


def eager_vs_captured(tag: str, tr, required, card: str, reps: int = 5) -> dict:
    """Phase 9 (a): from one trained state (the fill, whose refresh is the
    eager warm-up of the sweep's graph key, then one epoch), ``reps``
    steady eager sweeps (``scan=False``, after one more) against the
    captured sweep (``scan=True``: the capture and ``reps`` replays), each
    from the same state; every captured result equal to the eager one bit
    for bit (else within 1e-6 of the largest value, printed).  The
    counters, set to 0 before the captured sweeps, must hold the replays
    times the launches per replay, with every counter of ``required``; the
    graph's kernel nodes (kept with ``keep_graph``) must hold the launches
    per replay.  Prints the median seconds each way, the capture's and the
    peak device memory each way, over what was allocated when each refresh
    began."""
    from incagg_gnn_tpu_torch.models.base import RefreshGraphs
    from incagg_gnn_tpu_torch.ops import kernels as K

    tr.fill_history()
    plan = dict(tr.model._last_refresh_plan)
    if plan["mechanism"] != "sweep" or not plan["warmup"]:
        raise AssertionError(f"{tag}: the fill ran {plan}, not the sweep's warm-up")
    tr.cfg.fused_epoch = "auto"
    tr.train_epoch()
    start = refresh_state(tr)
    sweep_s(tr, False)
    eager, eager_peak = [], 0
    for _ in range(reps):
        set_state(tr, start)
        mark = peak_mark()
        eager.append(sweep_s(tr, False))
        eager_peak = max(eager_peak, mark())
    want = refresh_state(tr)
    if tr.model._last_refresh_plan["mechanism"] != "eager":
        raise AssertionError(f"{tag}: scan=False ran {tr.model._last_refresh_plan}")
    graphs = tr.model._refresh_graphs
    captures = graphs.captures
    for name in COUNTERS:
        getattr(K, name).launches = 0
    set_state(tr, start)
    mark = peak_mark()
    RefreshGraphs.keep_graph = True
    try:
        capture_s = sweep_s(tr, True)
    finally:
        RefreshGraphs.keep_graph = False
    captured_peak = mark()
    plan = dict(tr.model._last_refresh_plan)
    if (plan["mechanism"] != "sweep" or plan["warmup"]
            or plan["captures"] != captures + 1):
        raise AssertionError(f"{tag}: the captured refresh ran {plan} ({captures} "
                             f"captures before)")
    worst = [same_state(tag, refresh_state(tr), want)]
    replays = []
    for _ in range(reps):
        set_state(tr, start)
        mark = peak_mark()
        replays.append(sweep_s(tr, True))
        captured_peak = max(captured_peak, mark())
        worst.append(same_state(tag, refresh_state(tr), want))
    counts = {name: getattr(K, name).launches for name in COUNTERS}
    per = plan["launches_per_replay"]
    if tr.model._last_refresh_plan["captures"] != captures + 1:
        raise AssertionError(f"{tag}: a replay captured again")
    for name in COUNTERS:
        if counts[name] != (reps + 1) * per.get(name, 0):
            raise AssertionError(f"{tag}: {name} counted {counts[name]}, {reps + 1} "
                                 f"replays x {per.get(name, 0)}")
    for name in required:
        if not counts[name]:
            raise AssertionError(f"{tag}: kernel {name} not launched by the captured refresh")
    nodes = graph_kernel_nodes(graphs.sweep.graph)
    got, exp = nodes_by_counter(nodes, per)
    if got != exp:
        raise AssertionError(f"{tag}: the captured graph's kernel nodes {got}, the "
                             f"launches per replay {per} say {exp}")
    res = {"tag": tag, "eager_s": statistics.median(eager),
           "replay_s": statistics.median(replays), "capture_s": capture_s,
           "eager_peak": eager_peak, "captured_peak": captured_peak,
           "per_replay": per, "worst": max(worst), "counts": counts}
    log(f"  {tag} ({card}): {plan['n_batches']} batches, global columns "
        f"{plan['global_cols']}; eager sweep median {res['eager_s']:.4f} s "
        f"{[round(v, 4) for v in eager]}, captured: capture and first replay "
        f"{capture_s:.4f} s, replays median {res['replay_s']:.4f} s "
        f"{[round(v, 4) for v in replays]}; caches and logits "
        + ("bit for bit the eager sweep's" if res["worst"] == 0.0 else
           f"within {res['worst']:.2e} of the largest value (not bit for bit)")
        + f"; launches per replay {json.dumps(per)}, the graph's "
        f"{sum(nodes.values())} kernel nodes hold {json.dumps(got)}; peak device memory "
        f"above the state held, eager {eager_peak} B, captured (capture and replays) "
        f"{captured_peak} B")
    return res


def layers_path(tag: str, tr, card: str) -> None:
    """Phase 9 (b), on the trainer of GCN arxiv hybrid GAS: the trainer's
    refresh with ``refresh_frac=0.25`` (a rotating window of a quarter of
    the batches) four times, and then the whole set held on the host
    (``device_cache=False``) three times; each through the ``layers``
    mechanism (the first of each key the eager warm-up, the next capturing
    one graph per layer, the rest replaying) and equal to its eager twin
    (``scan=False`` on the same batches from the same state)."""
    import numpy as np

    nb, layers = len(tr.eval_loader), tr.model.cfg.num_layers
    start = refresh_state(tr)
    tr.cfg.refresh_frac = 0.25
    w = max(1, int(np.ceil(nb * 0.25)))
    lines = []
    for k in range(4):
        cur = tr._refresh_cursor
        set_state(tr, start)
        t = time.perf_counter()
        tr._refresh(host_logits=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        plan = dict(tr.model._last_refresh_plan)
        got = refresh_state(tr)
        set_state(tr, start)
        eager_dt = sweep_s(tr, False, subset=[(cur + j) % nb for j in range(w)])
        worst = same_state(f"{tag} refresh_frac window {k}", got, refresh_state(tr))
        if plan["mechanism"] != "layers" or plan["n_batches"] != w:
            raise AssertionError(f"{tag}: refresh_frac window {k} ran {plan}")
        lines.append(f"window {k} (from batch {cur}): {'warm-up' if plan['warmup'] else ''}"
                     f" {dt:.4f} s, captures {plan['captures']}, eager twin {eager_dt:.4f} s,"
                     f" {'equal' if worst == 0.0 else f'within {worst:.2e}'}")
    tr.cfg.refresh_frac = 1.0
    log(f"  {tag} refresh_frac=0.25 ({w} of {nb} batches, {card}): " + "; ".join(lines)
        + f"; launches per replay of each layer's graph "
        f"{json.dumps(plan['launches_per_replay'])}")
    captures = plan["captures"]
    ev = tr.eval_loader
    ev._cache, ev.device_cache = None, False  # held on the host from here
    lines = []
    try:
        for k in range(3):
            set_state(tr, start)
            dt = sweep_s(tr, True)
            plan = dict(tr.model._last_refresh_plan)
            got = refresh_state(tr)
            set_state(tr, start)
            eager_dt = sweep_s(tr, False)
            worst = same_state(f"{tag} host-held refresh {k}", got, refresh_state(tr))
            if plan["mechanism"] != "layers" or plan["on_device"]:
                raise AssertionError(f"{tag}: the host-held refresh {k} ran {plan}")
            lines.append(f"{'warm-up ' if plan['warmup'] else ''}{dt:.4f} s, captures "
                         f"{plan['captures']}, eager twin {eager_dt:.4f} s, "
                         f"{'equal' if worst == 0.0 else f'within {worst:.2e}'}")
        if plan["captures"] != captures + layers:
            raise AssertionError(f"{tag}: the host-held set captured "
                                 f"{plan['captures'] - captures} graphs, not {layers}")
    finally:
        ev._cache, ev.device_cache = None, None
    log(f"  {tag} eval set held on the host ({card}): " + "; ".join(lines))


def invalidation(tag: str, tr, ppi: dict, card: str) -> None:
    """Phase 9 (c): (1) on ``tr``: a captured sweep, then
    ``restore_checkpoint`` of the trainer's own state, which drops the
    graph: the next refresh captures anew and equals the eager sweep; (2) a
    GraphSAGE trainer at the ``ppi`` block on the ``ppi`` training graph:
    its sweep captured, then a ``full_forward`` of the val graph (one
    whole-graph batch, the eager loop), after which the trainer's graph
    replays with no capture and equals the eager sweep."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.train.config import load_config
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    sweep_s(tr, True)  # a replay of (a)'s graph
    if tr.model._refresh_graphs.sweep is None:
        raise AssertionError(f"{tag}: no sweep graph after (a)")
    start = refresh_state(tr)
    captures = tr.model._last_refresh_plan["captures"]
    tr.restore_checkpoint({k: v.clone() for k, v in tr.checkpoint_state().items()})
    if tr.model._refresh_graphs.sweep is not None:
        raise AssertionError(f"{tag}: restore_checkpoint left the refresh graph")
    set_state(tr, start)
    sweep_s(tr, True)
    plan = dict(tr.model._last_refresh_plan)
    got = refresh_state(tr)
    set_state(tr, start)
    sweep_s(tr, False)
    worst = same_state(f"{tag} after restore_checkpoint", got, refresh_state(tr))
    if plan["captures"] != captures + 1 or plan["warmup"] or plan["mechanism"] != "sweep":
        raise AssertionError(f"{tag}: after restore_checkpoint the refresh ran {plan} "
                             f"({captures} captures before)")
    log(f"  {tag}: after restore_checkpoint the next refresh captured anew (captures "
        f"{captures} -> {plan['captures']}) and equals the eager sweep "
        f"{'bit for bit' if worst == 0.0 else f'within {worst:.2e}'}")

    run_cfg = load_config(SAGE_YAML, "ppi", {})
    g = ppi["train"]
    model = build_model(run_cfg, g, g.num_features, g.num_classes, run_cfg.trainer.seed)
    sage = Trainer(model, g, run_cfg.trainer, "cuda")
    sage.fill_history()
    sweep_s(sage, True)
    plan = dict(sage.model._last_refresh_plan)
    if plan["mechanism"] != "sweep" or plan["captures"] != 1:
        raise AssertionError(f"GraphSAGE ppi: the second refresh ran {plan}")
    start = refresh_state(sage)
    t = time.perf_counter()
    logits = sage.full_forward(ppi["val"])
    ff_s = time.perf_counter() - t
    if sage.model._last_refresh_plan != plan or sage.model._refresh_graphs.sweep is None:
        raise AssertionError("GraphSAGE ppi: full_forward changed the trainer's plan or graph")
    if not (logits.shape == (ppi["val"].num_nodes, ppi["val"].num_classes)
            and bool(torch.isfinite(torch.from_numpy(logits)).all())):
        raise AssertionError(f"GraphSAGE ppi: full_forward logits {logits.shape}")
    replay_s = sweep_s(sage, True)
    after = dict(sage.model._last_refresh_plan)
    got = refresh_state(sage)
    set_state(sage, start)
    sweep_s(sage, False)
    worst = same_state("GraphSAGE ppi after full_forward", got, refresh_state(sage))
    if after["captures"] != plan["captures"] or after["mechanism"] != "sweep":
        raise AssertionError(f"GraphSAGE ppi: after full_forward the refresh ran {after}")
    log(f"  GraphSAGE ppi ({card}): full_forward of the val graph {ff_s:.3f} s left the "
        f"trainer's graph; the next refresh replayed it ({replay_s:.4f} s, captures "
        f"{after['captures']}) and equals the eager sweep "
        f"{'bit for bit' if worst == 0.0 else f'within {worst:.2e}'}")
    del sage, model


def staleness_short(card: str) -> dict:
    """Phase 9 (d): the staleness suite (``python -m
    incagg_gnn_tpu_torch.staleness_stress``) at ``--runs 1 --epochs 10`` on
    four of its configurations, with the refresh mechanisms each took: the
    rotating windows and refreshes inside an epoch on ``layers``, the
    frozen EMA on ``sweep``, none ``eager``."""
    from incagg_gnn_tpu_torch.staleness_stress import main as stress

    expect = {"gas-stress": "layers", "vr-stress-drift": "layers",
              "gas-stress-period3": "layers", "gas-frozen": "sweep"}
    out = stress(["--runs", "1", "--epochs", "10", "--configs", *expect,
                  "--out", os.path.join(ROOT, "build", "phase9_staleness.json")])
    for name, mech in expect.items():
        row = out["results"][name]
        took = row["refresh"]["mechanisms"]
        if mech not in took or any(k.startswith("eager") for k in took):
            raise AssertionError(f"staleness {name}: refreshes ran {took}, expected {mech}")
        if not all(math.isfinite(row[k]) for k in ("best", "acc10")):
            raise AssertionError(f"staleness {name}: {row}")
        log(f"  staleness {name} ({card}): best {row['best']:.4f} acc10 {row['acc10']:.4f} "
            f"epochs to 0.85 {row['epochs_to_thresh']}; refreshes {json.dumps(took)} in "
            f"{row['refresh']['seconds']:.3f} s")
    return out


def phase_refresh(card: str, ppi: dict) -> list:
    """Phase 9: (a) eager against captured sweeps on ``SWEEP_CONFIGS``; (b)
    the ``layers`` mechanism and (c) graph invalidation on GCN arxiv hybrid
    GAS; (d) the staleness suite.  Returns (a)'s results."""
    out = []
    for tag, yaml, block, overrides, required in SWEEP_CONFIGS:
        t = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        tr = make_trainer(yaml, block, overrides)
        out.append(eager_vs_captured(tag, tr, required, card))
        if tag == "GCN arxiv hybrid GAS":
            invalidation(tag, tr, ppi, card)
            layers_path(tag, tr, card)
        del tr
        log(f"  {tag}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    staleness_short(card)
    log(f"  phase 9 (d): {time.perf_counter() - t:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: multi-device training, ranks that share the one card
# ---------------------------------------------------------------------------

#: phase 10 (a): the products configuration at full width, in both modes,
#: over the exact-payload wire (the dense one: parts b-d)
P10_FULL = (GCN2_YAML, "sbm-products-mid")
P10_MODES = (("VR", ("adj_format=block", "vr_update=true", "halo_wire=ragged")),
             ("GAS", ("adj_format=block", "halo_wire=ragged")))  # GAS trains on hybrid
#: phase 10 (c, d): GCN at the arxiv widths on sbm-arxiv
P10_ARXIV = (GCN_YAML, "sbm-arxiv")


#: phase 10 (a)'s reference, kept by phase 7 from its fresh GCNII products
#: block VR trainer (the configuration of ``P10_MODES[0]``): the
#: single-device fill's logits and the graph as that trainer prepared it
P10_REFERENCE = {}


def p10_keep_reference(tr, logits) -> None:
    from incagg_gnn_tpu_torch.parallel.spatial import PreparedGraph, prepare_key

    P10_REFERENCE.update(logits=torch.from_numpy(logits), prepared=PreparedGraph(
        tr.data, tr.perm, tr.ptr, prepare_key(tr.cfg)))


def p10_data_file(yaml: str, dataset: str, prepared=None, overrides=(),
                  name=None) -> str:
    """The graph partitioned, permuted and normalized for the
    configuration (``prepare_graph``, or ``prepared``), pickled once into
    ``build/`` for the ranks to load: each would otherwise make and
    prepare it again."""
    import pickle

    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.parallel.spatial import prepare_graph
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides

    run_cfg = load_config(yaml, dataset, parse_overrides(list(overrides)))
    data, in_c, out_c = get_data("/tmp/datasets", run_cfg.dataset)
    if prepared is None:
        prepared = prepare_graph(data, run_cfg.trainer)
    path = os.path.join(ROOT, "build", f"{name or 'phase10_' + dataset}.pkl")
    with open(path + ".tmp", "wb") as f:
        # the trainer reads only the prepared graph (and the node count)
        pickle.dump((prepared.data, in_c, out_c, prepared), f, protocol=4)
    os.replace(path + ".tmp", path)
    return path


def p10_trainer(mesh, yaml: str, dataset: str, path: str, overrides=(), spill=False):
    """A sharded trainer on this rank as the CLI builds it (``spill``: the
    caches in host memory).  PNA's degree statistics come in ``overrides``,
    from the whole graph before it was prepared, as the CLI computes them."""
    import pickle

    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.parallel.spatial import ShardedVRTrainer
    from incagg_gnn_tpu_torch.parallel.spill_sharded import ShardedSpillVRTrainer
    from incagg_gnn_tpu_torch.train.config import load_config, parse_overrides

    with open(path, "rb") as f:
        data, in_c, out_c, prepared = pickle.load(f)
    run_cfg = load_config(yaml, dataset, parse_overrides(list(overrides)))
    model = build_model(run_cfg, data, in_c, out_c, run_cfg.trainer.seed)
    cls = ShardedSpillVRTrainer if spill else ShardedVRTrainer
    return cls(model, data, run_cfg.trainer, mesh, prepared=prepared)


def _sync_s(t0: float, device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def p12_serial_layer(tr):
    """A refresh layer pass as the serial loop the refresh ran before its
    exchange was pipelined, rebuilt from ``HaloExchange.collect`` /
    ``assemble`` and ``model._refresh_batch``: each round collects, then
    computes."""
    def layer_pass(layer, hist):
        src = tr.x_tab if layer == 0 else hist.emb[layer]
        for batch, ex in zip(tr._eval, tr._eval_halos):
            recv = ex.collect(src)
            tr.model._refresh_batch(layer, True, True, hist, tr.x_tab, tr.out_tab, batch,
                                    gather=lambda t, ex=ex, recv=recv: ex.assemble(t, recv))
    return layer_pass


def p12_refreshes(mesh, tr) -> dict:
    """Phase 12 (a) on one rank, from the filled state: a serial refresh,
    then a pipelined one, each with its seconds, the host seconds this rank
    was blocked waiting on all-to-all handles, its all-to-alls and its peak
    device memory above what was allocated when it began; the pipelined
    logits slab and caches must equal the serial ones bit for bit."""
    dev = mesh.device
    runs = {}
    for name in ("serial", "pipelined"):
        gc.collect()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        wait0, a2a0 = mesh.wait_s, mesh.calls["all_to_all"]
        if name == "serial":
            tr._refresh_layer = p12_serial_layer(tr)
        t = time.perf_counter()
        try:
            tr.refresh(host_logits=False)
        finally:
            if name == "serial":
                del tr._refresh_layer
        runs[name] = {"s": _sync_s(t, dev), "wait_s": mesh.wait_s - wait0,
                      "a2a": mesh.calls["all_to_all"] - a2a0,
                      "peak_above": torch.cuda.max_memory_allocated(dev) - base,
                      "state": [tr.out_tab.clone(), *(t.clone() for t in tr.hist.emb),
                                *(t.clone() for t in tr.hist.emb_ag)]}
    want, got = runs["serial"].pop("state"), runs["pipelined"].pop("state")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"phase 12 (a): rank {mesh.rank}'s pipelined refresh is "
                             f"not the serial one bit for bit")
    return runs


def p10_full_rank(mesh, yaml: str, dataset: str, path: str, epochs: int,
                  modes=P10_MODES, timed=()) -> dict:
    """Phase 10 (a) on one rank: for each mode (``(name, overrides)``, or
    ``(name, overrides, True)`` with the caches in host memory), the fill
    (a refresh: its seconds, wire bytes and payload) and ``epochs`` epochs,
    with this rank's launch counters (set to 0 before the mode),
    collectives, peak device memory and, spilled, the bytes staged each
    way after the fill and each epoch.  For the modes named in ``timed``
    phase 12 (a)'s refreshes follow the fill (:func:`p12_refreshes`)."""
    from incagg_gnn_tpu_torch.ops import kernels as K
    from incagg_gnn_tpu_torch.parallel import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, out = mesh.device, {}
    cuda = dev.type == "cuda"
    for mode, overrides, *spill in modes:
        spill = bool(spill and spill[0])
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        tr = p10_trainer(mesh, yaml, dataset, path, overrides, spill)
        setup_s = _sync_s(t, dev)
        for name in COUNTERS:
            getattr(K, name).launches = 0
        wire0 = mesh.wire_bytes
        t = time.perf_counter()
        tr.refresh(host_logits=False)
        fill_s = _sync_s(t, dev)
        wire = mesh.wire_bytes - wire0
        logits = tr.logits() if mesh.rank == 0 else M.all_gather(mesh, tr.out_tab)
        widths = [tr.x_tab.shape[1]] + [tr.model.hist_dim] * (tr.model.cfg.num_layers - 1)
        payload = sum(ex.payload_rows() for ex in tr._eval_halos) * sum(widths) * 4
        staged = [tr.spill_bytes()] if spill else []
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        refreshes = p12_refreshes(mesh, tr) if mode in timed else None
        if cuda and refreshes:
            torch.cuda.reset_peak_memory_stats(dev)
        epoch_s, losses, reduces = [], [], []
        for _ in range(epochs):
            calls0 = mesh.calls["all_reduce"]
            tr_ = tr.train_epoch()
            reduces.append((mesh.calls["all_reduce"] - calls0) / tr_["steps"])
            epoch_s.append(tr_["epoch_s"])
            losses.append(tr_["loss"])
            if spill:
                staged.append(tr.spill_bytes())
        out[mode] = {"staged": staged,
            "logits": logits if mesh.rank == 0 else None, "setup_s": setup_s,
            "fill_s": fill_s, "wire_bytes": wire,
            "payload_bytes": payload, "epoch_s": epoch_s, "losses": losses,
            "allreduce_per_step": reduces,
            "counts": {name: getattr(K, name).launches for name in COUNTERS},
            "peak_bytes": max(peak, torch.cuda.max_memory_allocated(dev)) if cuda else 0,
            "refreshes": refreshes,
            "fmt": (tr.plan.train.fmt, tr.plan.eval.fmt), "wire": tr.halo_wire,
            "plan_s": tr.plan_s,
            "slab": tr.layout.slab, "halo_width": tr.plan.eval.halo_width,
            "rounds": (tr._train_rounds, tr._eval_rounds)}
        del tr
    return out


def p10_round_rank(mesh, yaml: str, dataset: str, path: str, state_dir: str,
                   save: bool) -> dict:
    """Phase 10 (c) on one rank: GCN arxiv at 2 layers (for the script's
    time) from its seed, dropout 0, one Reverb and one GAS round from one
    state: the ranks that ``save`` fill the caches and write them to
    ``state_dir``, the others wait for those and read them instead of
    filling their own.  Returns the first step's
    reduced gradients, and the parameters and BatchNorm statistics after
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for mode, over in (("VR", ("vr_update=true",)), ("GAS", ())):
        tr = p10_trainer(mesh, yaml, dataset, path, ("dropout=0.0", "num_layers=2", *over))
        caches = [*tr.hist.emb, *tr.hist.emb_ag]
        state = os.path.join(state_dir, f"{mode}-{mesh.rank}.pt")
        if save:
            tr.refresh(host_logits=False)
            torch.save([t.cpu() for t in caches], state + ".tmp")
            os.replace(state + ".tmp", state)
        else:
            t_wait = time.perf_counter()
            while not os.path.exists(state):
                if os.path.exists(os.path.join(state_dir, "FAILED")):
                    raise RuntimeError("phase 10 (c): the card's ranks failed")
                if time.perf_counter() - t_wait > 600:
                    raise TimeoutError(f"phase 10 (c): no state {state} after 600 s")
                time.sleep(0.2)
            with torch.no_grad():
                for t, saved in zip(caches, torch.load(state)):
                    t.copy_(saved)
        grads = {}
        step = tr.opt.step

        def capture(tr=tr, grads=grads, step=step):
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in tr.model.named_parameters()})
            step()

        tr.opt.step = capture
        (tr._vr_step if tr.vr else tr._gas_step)(0)
        out[mode] = {"grads": grads, "params": {
            n: p.detach().cpu().clone() for n, p in tr.model.named_parameters()},
            "stats": {n: b.detach().cpu().clone() for n, b in tr.model.named_buffers()}}
        del tr
    return out


def p10_card_vs_cpu(path: str, spec=P10_ARXIV, device=None) -> dict:
    """Phase 10 (c): two ranks on the card fill the caches and take one
    round; two on the CPU take the same round from the card's caches.

    A round of GCN arxiv is one step of 40 clusters (~85,000 rows) a rank,
    and f32 sums over that many rows in another order differ by a few
    1e-5 of the largest gradient (4.6e-5 in Reverb, 3.0e-5 in GAS on an
    H100 against the CPU), so the gradients are held within 1e-4 x the
    largest.  Adam's
    first step moves a parameter by ``lr * g / (|g| + eps)``: where the
    gradient is rounding noise (a conv bias that feeds a BatchNorm, whose
    gradient is zero in exact arithmetic, or any |g| near eps) that is
    noise scaled to about ``lr``.  So the parameters after the round are
    held within 1e-4 x the largest where the CPU's gradient is resolved
    (|g| at least the gradient tolerance); the elements left out are
    counted and their largest difference printed.  The BatchNorm running
    statistics are held within 1e-4 x the largest everywhere."""
    import shutil

    from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks

    tol_g = tol_p = 1e-4
    work = os.path.join(ROOT, "build", "phase10_c")
    state = os.path.join(work, "state")
    shutil.rmtree(state, ignore_errors=True)
    os.makedirs(state)
    device = torch.device("cuda", 0) if device is None else device
    # the two groups run side by side: the CPU ranks build their trainers
    # while the card's fill, then wait for its caches
    t = time.perf_counter()
    card = {}

    def on_card():
        try:
            card["res"] = spawn_ranks(p10_round_rank, 2, [device] * 2, "gloo",
                                      args=(*spec, path, state, True),
                                      workdir=os.path.join(work, "card"), threads=2)
        except BaseException as e:  # raised again below
            card["err"] = e
            open(os.path.join(state, "FAILED"), "w").close()  # the CPU ranks stop
        card["s"] = time.perf_counter() - t

    thread = threading.Thread(target=on_card)
    thread.start()
    try:
        cpu = spawn_ranks(p10_round_rank, 2, [torch.device("cpu")] * 2, "gloo",
                          args=(*spec, path, state, False),
                          workdir=os.path.join(work, "cpu"), threads=3)
    finally:
        thread.join()
    if "err" in card:
        raise card["err"]
    gpu, t_gpu, t_cpu = card["res"], card["s"], time.perf_counter() - t
    worst, failed, left_out = {}, {}, {}

    def note(key, name, err, tol, scale):
        worst[key] = max(worst.get(key, 0.0), err / max(scale, 1e-30))
        if not err <= tol * max(scale, 1e-30):
            failed[f"{key} {name}"] = (f"{key} {name}: max abs err {err:.3e} over {tol:g} x "
                                       f"{scale:.3e}")

    for mode in ("VR", "GAS"):
        for g_rank, c_rank in zip(gpu, cpu):
            want, got = c_rank[mode], g_rank[mode]
            g_scale = max(float(g.abs().max()) for g in want["grads"].values())
            for name, g in want["grads"].items():
                note(f"{mode} grads", name, float((got["grads"][name] - g).abs().max()),
                     tol_g, g_scale)
            p_scale = max(float(p.abs().max()) for p in want["params"].values())
            for name, p in want["params"].items():
                diff = (got["params"][name] - p).abs()
                resolved = want["grads"][name].abs() >= tol_g * g_scale
                note(f"{mode} params", name, float(diff[resolved].max()) if resolved.any()
                     else 0.0, tol_p, p_scale)
                if not resolved.all():
                    n, e = left_out.get(mode, (0, 0.0))
                    left_out[mode] = (n + int((~resolved).sum()),
                                      max(e, float(diff[~resolved].max())))
            s_scale = max(float(b.abs().max()) for b in want["stats"].values()
                          if b.is_floating_point())
            for name, b in want["stats"].items():
                if b.is_floating_point():
                    note(f"{mode} stats", name, float((got["stats"][name] - b).abs().max()),
                         tol_p, s_scale)
    log(f"  (c) GCN arxiv at 2 layers, 2 ranks, one round each mode from the card's caches (card "
        f"{t_gpu:.1f} s, CPU {t_cpu:.1f} s, side by side): worst |card - cpu| / the largest value "
        f"{json.dumps(worst)}; parameters whose CPU gradient is under {tol_g:g} x the "
        f"largest (left out; count over both ranks, largest difference): "
        f"{json.dumps(left_out)}")
    if failed:
        raise AssertionError("phase 10 (c) GCN arxiv card against CPU: "
                             + "; ".join(failed.values()))
    return worst


def p10_nccl_world1(device, want: torch.Tensor, tol: float) -> None:
    """Phase 10 (b): the products model over NCCL at world size 1, in this
    process; its refresh equals the single-device refresh."""
    from incagg_gnn_tpu_torch.parallel import mesh as M

    init = os.path.join(ROOT, "build", "phase10_nccl_rendezvous")
    if os.path.exists(init):
        os.remove(init)
    mesh = M.init_distributed(0, 1, f"file://{init}", "nccl", device)
    try:
        # the dense wire: at world size 1 the ragged one has no rows to move
        tr = p10_trainer(mesh, *P10_FULL, os.path.join(ROOT, "build",
                                                      "phase10_sbm-products-mid.pkl"),
                         (*P10_MODES[0][1], "halo_wire=dense"))
        t = time.perf_counter()
        got = torch.from_numpy(tr.refresh())
        dt = _sync_s(t, device)
        err = float((got - want).abs().max())
        if not err <= tol * float(want.abs().max()):
            raise AssertionError(f"phase 10 (b): NCCL world 1 refresh off by {err:.3e}")
        ep = tr.train_epoch()
        log(f"  (b) GCNII products over NCCL at world size 1 ({tr.halo_wire} wire, "
            f"{tr.plan.eval.fmt} refresh): max |sharded - single| {err:.3e} "
            f"(max|logits| {float(want.abs().max()):.3e}); fill {dt:.3f} s; one VR epoch "
            f"{ep['epoch_s']:.3f} s, loss {ep['loss']:.4f}, collectives {mesh.calls}")
        del tr
    finally:
        M.shutdown()


def p10_cli(card: str) -> list:
    """Phase 10 (d): the CLI, 4 ranks on ``cuda:0`` over gloo, one epoch
    with a checkpoint, then a resume that must start at epoch 1."""
    import shutil

    from incagg_gnn_tpu_torch.__main__ import main as cli

    ck = os.path.join(ROOT, "build", "phase10_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--model", GCN_YAML, "--dataset", "arxiv", "dataset=sbm-arxiv",
            "--n-devices", "4", "--device", "cuda:0", "--dist-backend", "gloo",
            "--checkpoint-dir", ck, "adj_format=block"]
    t = time.perf_counter()
    first = cli(argv + ["epochs=1"])
    t1 = time.perf_counter() - t
    t = time.perf_counter()
    resumed = cli(argv + ["epochs=2"])
    t2 = time.perf_counter() - t
    if first["start_epoch"] != 0 or [e["epoch"] for e in first["epochs"]] != [0]:
        raise AssertionError(f"phase 10 (d): the first run trained {first['epochs']}")
    if resumed["start_epoch"] != 1 or [e["epoch"] for e in resumed["epochs"]] != [1]:
        raise AssertionError(f"phase 10 (d): the resume started at "
                             f"{resumed['start_epoch']}, not 1")
    for res in (first, resumed):
        for r in res["ranks"]:
            if not (r["launches"]["block_spmm"] and r["launches"]["ell_spmm"]):
                raise AssertionError(f"phase 10 (d): rank {r['rank']} launched no kernel "
                                     f"A or B: {r['launches']}")
    log(f"  (d) CLI GCN arxiv --n-devices 4 --device cuda:0 --dist-backend gloo: "
        f"epoch 0 in {t1:.1f} s (losses "
        f"{[round(e['loss'], 4) for e in first['epochs']]}, val "
        f"{first['epochs'][-1]['val_acc']:.4f}), resumed at epoch "
        f"{resumed['start_epoch']} in {t2:.1f} s (loss "
        f"{resumed['epochs'][0]['loss']:.4f}, val {resumed['epochs'][0]['val_acc']:.4f}); "
        f"formats {first['formats']}, wire {first['halo_wire']}; per rank: "
        + "; ".join(f"rank {r['rank']} A {r['launches']['block_spmm']} B "
                    f"{r['launches']['ell_spmm']} peak {r['peak_bytes']}"
                    for r in first["ranks"]) + f" [{card}]")
    return [{"counts": {k: r["launches"][k] for k in COUNTERS}}
            for res in (first, resumed) for r in res["ranks"]]


def p10_multi_gpu(path: str) -> None:
    """Phase 10 (e): two ranks over NCCL, one a GPU, where there are two."""
    from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks

    n = torch.cuda.device_count()
    if n < 2:
        log(f"  (e) not run: {n} GPU visible; two ranks over NCCL need two")
        return
    work = os.path.join(ROOT, "build", "phase10_e")
    os.makedirs(work, exist_ok=True)
    res = spawn_ranks(p10_round_rank, 2, [torch.device("cuda", r) for r in range(2)],
                      "nccl", args=(*P10_ARXIV, path, work, True), workdir=work)
    log(f"  (e) 2 ranks over NCCL on 2 GPUs: one VR and one GAS round, params of "
        f"rank 0 and 1 equal: {all(torch.equal(res[0][m]['params'][k], res[1][m]['params'][k]) for m in ('VR', 'GAS') for k in res[0][m]['params'])}")


#: phase 10 (a)'s Reverb run, kept for phase 11 (c) and phase 12 (a): every
#: rank's result and the single-device logits
P10_RUN = {}
#: phase 11's ranks' results, kept for phase 12 (d)
P11_RUN = {}


def p10_run_a(device, epochs: int, modes=P10_MODES):
    """Phase 10 (a)'s spawn: the single-device fill (phase 7's, or made
    here), the products graph as that trainer prepared it, then 4 ranks on
    ``device`` over gloo through :func:`p10_full_rank`, phase 12 (a)'s
    refreshes after the Reverb fill.  Keeps the Reverb run in ``P10_RUN``;
    returns every rank's result and the single-device logits."""
    from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks

    t = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    if not P10_REFERENCE:  # phase 7 did not run
        single = make_trainer(*P10_FULL, P10_MODES[0][1])
        p10_keep_reference(single, single.fill_history())
        del single
        gc.collect()
        torch.cuda.empty_cache()
    want = P10_REFERENCE["logits"]
    # the ranks take the graph as the single-device trainer prepared it
    products = p10_data_file(*P10_FULL, prepared=P10_REFERENCE.pop("prepared"))
    log(f"  the single-device fill and the graphs for the ranks: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    res = spawn_ranks(p10_full_rank, 4, [device] * 4, "gloo",
                      args=(*P10_FULL, products, epochs, modes, ("VR",)),
                      workdir=os.path.join(ROOT, "build", "phase10_a"), threads=2)
    log(f"  (a) spawned run: {time.perf_counter() - t:.1f} s")
    P10_RUN.update(epochs=epochs, ranks=[r["VR"] for r in res], want=want)
    return res, want


def phase_sharded(device, card: str, epochs: int = 2) -> list:
    """Phase 10: (a) GCNII products at full width, 4 ranks on ``cuda:0``
    over gloo, in Reverb (``bi-block`` training, block refresh) and GAS
    (hybrid): the fill against the single-device ``Trainer``'s from the
    same parameters, then ``epochs`` epochs each, with the seconds, halo
    bytes, all-reduces a step, kernel launches and peak memory of each
    rank; (b) the same model over NCCL at world size 1; (c) GCN arxiv, 2
    ranks, card against CPU; (d) the CLI with a checkpoint and a resume;
    (e) NCCL over two GPUs where there are two.  Returns each rank's
    counters of (a) and (d)."""
    tol = 1e-4
    res, want = p10_run_a(device, epochs)
    arxiv = p10_data_file(*P10_ARXIV)
    scale = float(want.abs().max())
    for mode, _ in P10_MODES:
        r0 = res[0][mode]
        err = float((torch.from_numpy(r0["logits"]) - want).abs().max())
        if not err <= tol * scale:
            raise AssertionError(f"phase 10 (a) {mode}: the 4-rank refresh is off the "
                                 f"single-device one by {err:.3e} (max|logits| {scale:.3e})")
        for r in res:
            c = r[mode]["counts"]
            if not (c["block_spmm"] and c["ell_spmm"]):
                raise AssertionError(f"phase 10 (a) {mode}: a rank launched no kernel A "
                                     f"or B: {c}")
            if c["hybrid_spmm"] != c["ell_spmm"]:
                raise AssertionError(f"phase 10 (a) {mode}: kernel B unfused: {c}")
        steady = statistics.median(r0["epoch_s"][1:])
        log(f"  (a) GCNII products {mode}, 4 ranks sharing one {card} over gloo "
            f"({r0['wire']} wire; train {r0['fmt'][0]}, refresh {r0['fmt'][1]}; slab "
            f"{r0['slab']} rows, rounds {r0['rounds']}, halo width {r0['halo_width']}): "
            f"max |sharded - single| {err:.3e} (max|logits| {scale:.3e}); epoch s "
            f"{[round(x, 4) for x in r0['epoch_s']]} (median after the first {steady:.4f}); "
            f"fill (a refresh) {r0['fill_s']:.3f} s; losses "
            f"{[round(x, 4) for x in r0['losses']]}; all-reduces a step "
            f"{r0['allreduce_per_step']}")
        for rank, r in enumerate(res):
            m = r[mode]
            log(f"    rank {rank}: set-up {m['setup_s']:.1f} s (the plan made and "
                f"scattered {m['plan_s']:.1f} s), halo a refresh "
                f"payload {m['payload_bytes']} B wire {m['wire_bytes']} B; launches A "
                f"{m['counts']['block_spmm']} B {m['counts']['ell_spmm']} (fused "
                f"{m['counts']['hybrid_spmm']}); peak device memory {m['peak_bytes']} B")
    t = time.perf_counter()
    p10_nccl_world1(device, want, tol)
    log(f"  (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    p10_card_vs_cpu(arxiv)
    log(f"  (c): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cli_counts = p10_cli(card)
    log(f"  (d): {time.perf_counter() - t:.1f} s")
    p10_multi_gpu(arxiv)
    return [{"counts": r[mode]["counts"]} for r in res for mode, _ in P10_MODES] + cli_counts


# ---------------------------------------------------------------------------
# phase 11: sharded GAT and PNA, and the sharded spill tier
# ---------------------------------------------------------------------------

#: phase 11 (a, b): the arxiv configurations of GAT and PNA on sbm-arxiv,
#: each in Reverb (GAT on the hybrid pair with t2f, PNA true_vr) and GAS
#: (GAT on COO, PNA on the hybrid pair)
P11_MODELS = (("GAT", GAT_YAML, (("VR", ("vr_update=true",)), ("GAS", ()))),
              ("PNA", PNA_YAML, (("VR", ("vr_update=true", "true_vr=true")),
                                 ("GAS", ()))))
P11_EPOCHS = 2
P11_DATASET = "sbm-arxiv"  # the graph of the YAML's arxiv block
GB = 1 << 30


def p11_rank(mesh, jobs) -> dict:
    """Phase 11 (a-d) on one rank: each job ``(tag, yaml, dataset, path,
    epochs, modes[, timed])`` through :func:`p10_full_rank`."""
    out = {}
    for tag, yaml, dataset, path, epochs, modes, *timed in jobs:
        t = time.perf_counter()
        out[tag] = p10_full_rank(mesh, yaml, dataset, path, epochs, modes, *timed)
        out[tag]["job_s"] = time.perf_counter() - t
    return out


def p11_rank_lines(tag: str, mode: str, res: list) -> None:
    """Each rank's seconds, halo bytes, launches, peak memory and, spilled,
    the bytes staged each way per phase."""
    for rank, r in enumerate(res):
        m = r[tag][mode]
        c = m["counts"]
        staged, prev = {}, {"h2d": 0, "d2h": 0}
        for phase, now in zip(["fill"] + [f"train{e}" for e in range(len(m["epoch_s"]))],
                              m["staged"]):
            staged[phase] = {k: now[k] - prev[k] for k in now}
            prev = now
        log(f"    rank {rank}: set-up {m['setup_s']:.2f} s (plan {m['plan_s']:.2f}), fill "
            f"(the run's refresh) {m['fill_s']:.3f} s, epochs "
            f"{[round(x, 4) for x in m['epoch_s']]} s; halo a refresh payload "
            f"{m['payload_bytes']} B wire {m['wire_bytes']} B; launches A {c['block_spmm']} "
            f"B {c['ell_spmm']} (fused {c['hybrid_spmm']}, heads {c['hybrid_spmm_heads']}) "
            f"max {c['hybrid_max']} max bwd {c['hybrid_max_bwd']}; peak device memory "
            f"{m['peak_bytes']} B" + (f"; staged {json.dumps(staged)}" if staged else ""))


def p11_models(res: list, refs: dict, card: str) -> None:
    """Phase 11 (a, b): each mode's fill against the single-device fill,
    the kernels every rank must launch."""
    tol = 1e-4
    for tag, _, modes in P11_MODELS:
        want = refs[tag]
        scale = float(want.abs().max())
        for mode, _ in modes:
            r0 = res[0][tag][mode]
            got = torch.from_numpy(r0["logits"])
            err = float((got - want).abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"phase 11 {tag} {mode}: the 4-rank fill is off the "
                                     f"single-device one by {err:.3e} (max {scale:.3e})")
            for rank, r in enumerate(res):
                c = r[tag][mode]["counts"]
                if tag == "GAT" and mode == "VR" and not c["hybrid_spmm_heads"]:
                    raise AssertionError(f"phase 11 GAT VR: rank {rank} launched no heads "
                                         f"form: {c}")
                if tag == "PNA" and not (c["hybrid_max"] and c["hybrid_max_bwd"]):
                    raise AssertionError(f"phase 11 PNA {mode}: rank {rank} launched no "
                                         f"max form or no max backward: {c}")
                if c["hybrid_spmm"] != c["ell_spmm"]:
                    raise AssertionError(f"phase 11 {tag} {mode}: rank {rank} launched "
                                         f"kernel B unfused: {c}")
            log(f"  ({'a' if tag == 'GAT' else 'b'}) {tag} arxiv {mode}, 4 ranks sharing one "
                f"{card} over gloo ({r0['wire']} wire; train {r0['fmt'][0]}, refresh "
                f"{r0['fmt'][1]}; slab {r0['slab']} rows, rounds {r0['rounds']}, halo width "
                f"{r0['halo_width']}): max |sharded - single| {err:.3e} (max|logits| "
                f"{scale:.3e}; bit for bit: {torch.equal(got, want)}); losses "
                f"{[round(x, 4) for x in r0['losses']]}; all-reduces a step "
                f"{r0['allreduce_per_step']}")
            p11_rank_lines(tag, mode, res)


def p11_spill(res: list, tag: str, device_mode: str, spill_mode: str, ref=None,
              min_saved=None) -> None:
    """Phase 11 (c, d): the spilled run against its device-cache twin (in
    ``res``, or ``ref``: phase 10 (a)'s ranks): fill logits and losses bit
    for bit; with ``min_saved``, each rank's peak device memory lower by
    that many bytes (printed either way)."""
    import numpy as np

    twin = ref if ref is not None else [r[tag][device_mode] for r in res]
    spilled = [r[tag][spill_mode] for r in res]
    if not np.array_equal(spilled[0]["logits"], twin[0]["logits"]):
        err = float(np.abs(spilled[0]["logits"] - twin[0]["logits"]).max())
        raise AssertionError(f"phase 11 {tag}: spilled fill off the device-cache one by "
                             f"{err:.3e}")
    saved = []
    for rank, (s_, d_) in enumerate(zip(spilled, twin)):
        if s_["losses"] != d_["losses"]:
            raise AssertionError(f"phase 11 {tag}: rank {rank} losses {s_['losses']} "
                                 f"spilled, {d_['losses']} with device caches")
        saved.append(d_["peak_bytes"] - s_["peak_bytes"])
        if min_saved is not None and saved[-1] < min_saved:
            raise AssertionError(f"phase 11 {tag}: rank {rank}'s peak device memory is "
                                 f"{saved[-1]} B below the device-cache run's, not "
                                 f"{min_saved}")
    log(f"  {tag}: spilled against device caches: fill logits and losses "
        f"{[round(x, 6) for x in spilled[0]['losses']]} bit for bit; peak device memory "
        f"lower by {saved} B a rank (device caches {[d['peak_bytes'] for d in twin]} B)"
        + (f"; the device-cache run's epochs {[round(x, 4) for x in twin[0]['epoch_s']]} s"
           if ref is None else " (phase 10 a's Reverb run)"))
    p11_rank_lines(tag, spill_mode, res)


def p11_cli(card: str) -> list:
    """Phase 11 (e): the CLI, 4 ranks on ``cuda:0`` over gloo: ``--spill``
    one epoch with a checkpoint; then, with ``INCAGG_HBM_BUDGET_MB=64`` and
    no ``--spill``, a resume to epoch 2 that the memory gate must send to
    the spill tier, with its log line."""
    import logging
    import shutil

    from incagg_gnn_tpu_torch.__main__ import main as cli

    ck = os.path.join(ROOT, "build", "phase11_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--model", GCN_YAML, "--dataset", "arxiv", "dataset=sbm-arxiv",
            "--n-devices", "4", "--device", "cuda:0", "--dist-backend", "gloo",
            "--checkpoint-dir", ck]
    t = time.perf_counter()
    first = cli(argv + ["--spill", "epochs=1"])
    t1 = time.perf_counter() - t
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    logger = logging.getLogger("incagg_gnn_tpu_torch")
    level = logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    os.environ["INCAGG_HBM_BUDGET_MB"] = "64"
    t = time.perf_counter()
    try:
        resumed = cli(argv + ["epochs=2"])
    finally:
        del os.environ["INCAGG_HBM_BUDGET_MB"]
        logger.removeHandler(keep)
        logger.setLevel(level)
    t2 = time.perf_counter() - t
    gate = [x for x in lines if x.startswith("sharded spill tier: cache slab")]
    if first["tier"] != "spill" or [e["epoch"] for e in first["epochs"]] != [0]:
        raise AssertionError(f"phase 11 (e): --spill ran tier {first['tier']}, epochs "
                             f"{first['epochs']}")
    if resumed["tier"] != "spill" or not gate:
        raise AssertionError(f"phase 11 (e): over the budget the gate chose "
                             f"{resumed['tier']}; log line {gate}")
    if resumed["start_epoch"] != 1 or [e["epoch"] for e in resumed["epochs"]] != [1]:
        raise AssertionError(f"phase 11 (e): the resume started at "
                             f"{resumed['start_epoch']}, not 1")
    for res in (first, resumed):
        for r in res["ranks"]:
            if not r["launches"]["ell_spmm"]:
                raise AssertionError(f"phase 11 (e): rank {r['rank']} launched no kernel "
                                     f"B: {r['launches']}")
    log(f"  (e) CLI GCN arxiv --n-devices 4 --spill: epoch 0 in {t1:.1f} s (loss "
        f"{first['epochs'][0]['loss']:.4f}); INCAGG_HBM_BUDGET_MB=64 without --spill: "
        f"{gate[0]!r}; resumed at epoch {resumed['start_epoch']} in {t2:.1f} s (loss "
        f"{resumed['epochs'][0]['loss']:.4f}, val {resumed['epochs'][0]['val_acc']:.4f}); "
        f"per rank (first run): " + "; ".join(
            f"rank {r['rank']} A {r['launches']['block_spmm']} B {r['launches']['ell_spmm']}"
            f" peak {r['peak_bytes']} staged {json.dumps(r['spill_bytes'].get('train0'))}"
            for r in first["ranks"]) + f" [{card}]")
    return [{"counts": {k: r["launches"][k] for k in COUNTERS}}
            for res in (first, resumed) for r in res["ranks"]]


def phase_sharded_models(device, card: str) -> list:
    """Phase 11: (a) GAT and (b) PNA arxiv sharded in both modes against
    their single-device fills, (c) GCNII products Reverb spilled against
    phase 10 (a)'s Reverb run (run here first when phase 10 did not run),
    (d) GCN arxiv GAS spilled against device caches, all in one spawn of 4
    ranks on ``device``; (e) the CLI.  Returns every rank's counters."""
    from incagg_gnn_tpu_torch.graph.datasets import get_data
    from incagg_gnn_tpu_torch.models.pna import compute_avg_deg
    from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks
    from incagg_gnn_tpu_torch.parallel.spatial import PreparedGraph, prepare_key

    t = time.perf_counter()
    raw, _, _ = get_data("/tmp/datasets", P11_DATASET)
    lin, lg = compute_avg_deg(raw.adj_t.degrees())
    jobs, refs = [], {}
    for tag, yaml, modes in P11_MODELS:
        base = (f"dataset={P11_DATASET}",) + (
            (f"avg_deg_lin={lin!r}", f"avg_deg_log={lg!r}") if tag == "PNA" else ())
        gc.collect()
        torch.cuda.empty_cache()
        single = make_trainer(yaml, "arxiv", base + modes[0][1])
        refs[tag] = torch.from_numpy(single.fill_history())
        path = p10_data_file(yaml, "arxiv", PreparedGraph(
            single.data, single.perm, single.ptr, prepare_key(single.cfg)), base,
            name=f"phase11_{tag}")
        del single
        jobs.append((tag, yaml, "arxiv", path, P11_EPOCHS,
                     tuple((m, base + o) for m, o in modes)))
    gc.collect()
    torch.cuda.empty_cache()
    products = os.path.join(ROOT, "build", "phase10_sbm-products-mid.pkl")
    ref = P10_RUN.get("ranks")
    if ref is None or not os.path.exists(products):
        products, ref = p10_data_file(*P10_FULL), None
    epochs = P10_RUN.get("epochs", 2)
    spill_modes = ((("VR", P10_MODES[0][1]),) if ref is None else ()) + (
        ("VR-spill", P10_MODES[0][1], True),)
    jobs.append(("GCNII products", *P10_FULL, products, epochs, spill_modes))
    arxiv = os.path.join(ROOT, "build", "phase10_sbm-arxiv.pkl")
    if not os.path.exists(arxiv):
        arxiv = p10_data_file(*P10_ARXIV)
    jobs.append(("GCN arxiv", *P10_ARXIV, arxiv, P11_EPOCHS,
                 (("GAS", ()), ("GAS-spill", (), True))))
    jobs.append(p12_bf16_job(products))
    log(f"  the single-device fills and the graphs for the ranks: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    res = spawn_ranks(p11_rank, 4, [device] * 4, "gloo", args=(jobs,),
                      workdir=os.path.join(ROOT, "build", "phase11_a"), threads=2)
    log(f"  (a-d) spawned run: {time.perf_counter() - t:.1f} s (jobs "
        f"{ {j[0]: round(res[0][j[0]]['job_s'], 1) for j in jobs} } s on rank 0)")
    p11_models(res, refs, card)
    p11_spill(res, "GCNII products", "VR", "VR-spill", ref=ref, min_saved=int(0.3 * GB))
    # GCN arxiv's caches are 0.26 GB a rank, and a GAS round stages its
    # whole batch's rows of two layers: no bound on its peak is asserted
    p11_spill(res, "GCN arxiv", "GAS", "GAS-spill")
    P11_RUN.update(res=res)
    t = time.perf_counter()
    cli_counts = p11_cli(card)
    log(f"  (e): {time.perf_counter() - t:.1f} s")
    return [{"counts": r[j[0]][m[0]]["counts"]} for r in res for j in jobs
            for m in j[5]] + cli_counts


# ---------------------------------------------------------------------------
# phase 12: the pipelined refresh, scaling_bench, --runs with --n-devices,
# the spill tier at bfloat16 and the memory gate under torchrun
# ---------------------------------------------------------------------------

def p12_bf16_job(products: str) -> tuple:
    """Phase 12 (d)'s job in phase 11's spawn: GCNII products Reverb with
    bfloat16 caches, on the device and spilled, one epoch."""
    over = P10_MODES[0][1] + ("hist_dtype=bfloat16",)
    return ("GCNII products bf16", *P10_FULL, products, 1,
            (("VR", over), ("VR-spill", over, True)))


def p12_pipelined(device, card: str) -> list:
    """Phase 12 (a): the Reverb fill of phase 10 (a) (the pipelined
    refresh) equal to phase 7's single-device refresh bit for bit, and each
    rank's serial and pipelined refreshes after it (:func:`p12_refreshes`):
    seconds, time blocked on handles against the serial loop's, peak
    device memory.  Runs phase 10 (a)'s spawn in Reverb alone when phase
    10 did not run; returns its counters then."""
    counts = []
    if not P10_RUN:
        res, _ = p10_run_a(device, 1, (P10_MODES[0],))
        counts = [{"counts": r["VR"]["counts"]} for r in res]
    ranks, want = P10_RUN["ranks"], P10_RUN["want"]
    got = torch.from_numpy(ranks[0]["logits"])
    if not torch.equal(got, want):
        raise AssertionError(f"phase 12 (a): the pipelined 4-rank fill is off the "
                             f"single-device refresh by {float((got - want).abs().max()):.3e}")
    r0 = ranks[0]
    log(f"  (a) GCNII products Reverb, 4 ranks sharing one {card} over gloo ({r0['wire']} "
        f"wire, {r0['rounds'][1]} eval rounds x 5 layers): the pipelined fill equals the "
        f"single-device refresh bit for bit; fill s a rank "
        f"{[round(r['fill_s'], 3) for r in ranks]}")
    for rank, r in enumerate(ranks):
        rf = r["refreshes"]
        ser, pipe = rf["serial"], rf["pipelined"]
        if not ser["a2a"] == pipe["a2a"] > 0:
            raise AssertionError(f"phase 12 (a): rank {rank}'s all-to-alls a refresh: "
                                 f"serial {ser['a2a']}, pipelined {pipe['a2a']}")
        hidden = 1.0 - pipe["wait_s"] / max(ser["wait_s"], 1e-12)
        log(f"    rank {rank}: refresh s serial {ser['s']:.3f}, pipelined {pipe['s']:.3f}; "
            f"blocked on handles serial {ser['wait_s']:.3f} s, pipelined "
            f"{pipe['wait_s']:.3f} s (hidden share {hidden:.3f}); {pipe['a2a']} "
            f"all-to-alls; peak above the refresh's start serial {ser['peak_above']} B, "
            f"pipelined {pipe['peak_above']} B; mode peak {r['peak_bytes']} B")
    return counts


def p12_scaling(card: str) -> dict:
    """Phase 12 (b): ``scaling_bench`` at its full width (GCN 3 x 256) on a
    50,000-node SBM of 16 parts (a quarter of the tool's default graph, for
    the script's time; ``docs/scaling_port_r01.json`` holds the default's),
    ranks 1 2 4 sharing the card over gloo and one NCCL row at world size
    1, 2-3 repetitions a leg; every row printed, and the artifact either
    consistent or stamped invalid with its reasons.  The start-load guard
    is set to the host's CPU count: the earlier phases' own processes leave
    the one-minute load above the script's default of 0.8.  No prior
    artifact is read: on a slower host the prior guard would run legs
    again, which this script's time limit cannot afford."""
    from incagg_gnn_tpu_torch import scaling_bench

    out = os.path.join(ROOT, "build", "scaling_port.json")
    res = scaling_bench.main([
        "--device", "cuda:0", "--devices", "1", "2", "4", "--nccl-world1",
        "--num-nodes", "50000", "--num-parts", "16",
        "--mesh2d", "none", "--prior", "none", "--min-reps", "2", "--max-reps", "3",
        "--max-start-load", str(os.cpu_count() or 1),
        "--workdir", os.path.join(ROOT, "build", "phase12_b"), "--out", out])
    rows = res["decomposition"] + [res["nccl_world1"]]
    if sorted(r["devices"] for r in res["decomposition"]) != [1, 2, 4]:
        raise AssertionError(f"phase 12 (b): rows at {[r['devices'] for r in rows]}")
    for r in rows:
        if r["all_to_all_per_refresh_and_epoch_loopback"] != 0:
            raise AssertionError(f"phase 12 (b): the loopback leg at {r['devices']} ranks "
                                 f"made all-to-alls")
        log(f"    {r['backend']} x{r['devices']} ({r['wire_full']} / loopback): train s "
            f"{r['train_s_full']} / {r['train_s_loopback']}, refresh s {r['refresh_s_full']} / "
            f"{r['refresh_s_loopback']}, wire share {r.get('comm_fraction_measured', '-')}, "
            f"overhead vs 1 rank {r.get('sharding_overhead_vs_1dev', '-')}, peak rank 0 "
            f"{r['peak_bytes_rank0']}")
    issues = [m for r in res["decomposition"] for m in scaling_bench.row_issues(r)]
    if res["valid"] and issues:
        raise AssertionError(f"phase 12 (b): stamped valid with issues {issues}")
    if not res["valid"] and not (res["consistency_issues"] or res["suspect_legs"]):
        raise AssertionError("phase 12 (b): stamped invalid without a reason")
    log(f"  (b) scaling_bench ({res['platform']}; {res['card']}): valid {res['valid']} "
        f"{res['consistency_issues'] + res['suspect_legs']}; all-to-all alone "
        f"{json.dumps(res['all_to_all_microbench'])}; halo {json.dumps(res['halo_bytes'])}; "
        f"artifact {out}")
    return res


def p12_runs(card: str) -> list:
    """Phase 12 (c): the CLI, ``--runs 2 --n-devices 2`` on GCN arxiv (one
    epoch a run, 2 ranks on ``cuda:0`` over gloo): each run's val/test
    logged and the summary line the single-device loop logs, matched."""
    import logging
    import re

    from incagg_gnn_tpu_torch.__main__ import main as cli

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    logger = logging.getLogger("incagg_gnn_tpu_torch")
    level = logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    t = time.perf_counter()
    try:
        res = cli(["--model", GCN_YAML, "--dataset", "arxiv", "dataset=sbm-arxiv",
                   "--n-devices", "2", "--device", "cuda:0", "--dist-backend", "gloo",
                   "--runs", "2", "epochs=1"])
    finally:
        logger.removeHandler(keep)
        logger.setLevel(level)
    dt = time.perf_counter() - t
    per_run = [x for x in lines if re.match(r"run [01]: val \d\.\d{4} test \d\.\d{4}$", x)]
    summary = [x for x in lines if re.match(
        r"2 runs — Val: \d\.\d{4} ± \d\.\d{4}, Test: \d\.\d{4} ± \d\.\d{4}$", x)]
    if len(res["runs"]) != 2 or len(per_run) != 2 or len(summary) != 1:
        raise AssertionError(f"phase 12 (c): runs {len(res['runs'])}, lines {per_run} "
                             f"{summary}")
    want = f"2 runs — Val: {res['best_val']:.4f}"
    if not summary[0].startswith(want):
        raise AssertionError(f"phase 12 (c): {summary[0]!r} against the runs' mean {want!r}")
    for r in res["ranks"]:
        if not r["launches"]["ell_spmm"]:
            raise AssertionError(f"phase 12 (c): rank {r['rank']} launched no kernel B")
    log(f"  (c) CLI GCN arxiv --runs 2 --n-devices 2 ({dt:.1f} s): {per_run}; {summary[0]!r} "
        f"[{card}]")
    return [{"counts": {k: r["launches"][k] for k in COUNTERS}} for r in res["ranks"]]


def p12_torchrun(card: str) -> None:
    """Phase 12 (d): the memory gate on ranks that ``torchrun`` started:
    2 ranks on ``cuda:0`` over gloo with ``INCAGG_HBM_BUDGET_MB=0``, GCN on
    ``sbm-small`` (the gate's path, not the graph, is what this checks),
    ``--runs 2`` (the seed loop in the joined ranks), one epoch a run: the
    log must say "sharded spill tier" and give the summary."""
    path = os.path.join(ROOT, "build", "phase12_torchrun.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "incagg_gnn_tpu_torch", "--model", GCN_YAML,
           "--dataset", "sbm-small", "--n-devices", "2",
           "--device", "cuda:0", "--dist-backend", "gloo", "--runs", "2", "epochs=1"]
    t = time.perf_counter()
    with open(path, "w") as f:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, timeout=600,
                            env={**os.environ, "INCAGG_HBM_BUDGET_MB": "0"}).returncode
    with open(path) as f:
        text = f.read()
    gate = [x for x in text.splitlines() if x.startswith("sharded spill tier: cache slab")]
    summary = [x for x in text.splitlines() if x.startswith("2 runs — Val: ")]
    if rc != 0 or len(gate) != 2 or len(summary) != 1:
        raise AssertionError(f"phase 12 (d): torchrun exit {rc}, gate lines {gate}, "
                             f"summary {summary} (log {path})")
    log(f"  (d) torchrun --nproc-per-node 2, INCAGG_HBM_BUDGET_MB=0 ({time.perf_counter() - t:.1f} "
        f"s): {gate[0]!r} (each run); {summary[0]!r} [{card}]")


def phase_pipelined(device, card: str) -> list:
    """Phase 12: (a) the pipelined refresh (phase 10 a's Reverb run);
    (b) ``scaling_bench``; (c) the CLI's ``--runs 2 --n-devices 2``; (d)
    the spill tier at bfloat16 caches against its device-cache twin
    (phase 11's spawn, or one here) and the memory gate under
    ``torchrun``.  Returns the counters of the runs it made."""
    t = time.perf_counter()
    counts = p12_pipelined(device, card)
    log(f"  (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    p12_scaling(card)
    log(f"  (b): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts += p12_runs(card)
    log(f"  (c): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    if not P11_RUN:
        from incagg_gnn_tpu_torch.parallel.launch import spawn_ranks

        products = os.path.join(ROOT, "build", "phase10_sbm-products-mid.pkl")
        if not os.path.exists(products):
            products = p10_data_file(*P10_FULL)
        job = p12_bf16_job(products)
        res = spawn_ranks(p11_rank, 4, [device] * 4, "gloo", args=([job],),
                          workdir=os.path.join(ROOT, "build", "phase12_d"), threads=2)
        P11_RUN.update(res=res)
        counts += [{"counts": r[job[0]][m[0]]["counts"]} for r in res for m in job[5]]
    p11_spill(P11_RUN["res"], "GCNII products bf16", "VR", "VR-spill")
    p12_torchrun(card)
    log(f"  (d): {time.perf_counter() - t:.1f} s")
    return counts


def run_only(only: set, device, card: str, t_start: float) -> int:
    """``--phases``: the phases asked for that stand alone (10, 11, 12)."""
    if only - {10, 11, 12}:
        raise SystemExit(f"--phases: only phases 10, 11 and 12 run alone, not "
                         f"{sorted(only - {10, 11, 12})}")
    if 10 in only:
        log("phase 10: multi-device training, ranks sharing the card")
        t = time.perf_counter()
        phase_sharded(device, card)
        log(f"  phase 10: {time.perf_counter() - t:.1f} s")
    if 11 in only:
        log("phase 11: sharded GAT and PNA, the sharded spill tier")
        t = time.perf_counter()
        phase_sharded_models(device, card)
        log(f"  phase 11: {time.perf_counter() - t:.1f} s")
    if 12 in only:
        log("phase 12: the pipelined refresh, scaling_bench, --runs, the bf16 spill tier, the gate under torchrun")
        t = time.perf_counter()
        phase_pipelined(device, card)
        log(f"  phase 12: {time.perf_counter() - t:.1f} s")
    log(f"  total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "phases": sorted(only), "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    ap.add_argument("--phases", type=int, nargs="*", default=None,
                    help="run only these phases after 0 and 1 (a development "
                         "aid: no kernels line, last line ok when they pass)")
    args = ap.parse_args(argv)
    only = set(args.phases or ())
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
    from incagg_gnn_tpu_torch.ops import kernels as K
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

    make_each_graph_once()
    if only:
        return run_only(only, device, card, t_start)
    t = time.perf_counter()
    ppi = ppi_graphs()
    log(f"  ppi graphs (phases 2 and 8): {time.perf_counter() - t:.1f} s")
    log("phase 2: kernels vs plain versions, library calls and bounds")
    t = time.perf_counter()
    kres = phase_kernels(device, ppi["val"])
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
            run_slice(GCN2_YAML, "sbm-products-mid", "hybrid", vr=False),
            run_slice(SAGE_YAML, "sbm-reddit-mid", "block", vr=False),
            run_slice(SAGE_YAML, "sbm-reddit-mid", "block", vr=True),
            run_slice(SAGE_YAML, "sbm-reddit-mid", "hybrid", vr=False),
            run_slice(SAGE_YAML, "sbm-reddit-mid", "coo", vr=False,
                      extra=("edge_dropout=0.2",)),
            run_slice(APPNP_YAML, "arxiv", "hybrid", vr=False, extra=("dataset=sbm-arxiv",)),
            run_slice(APPNP_YAML, "arxiv", "block", vr=True, extra=("dataset=sbm-arxiv",)),
            run_slice(GAT_YAML, "arxiv", "hybrid", vr=False, extra=("dataset=sbm-arxiv",)),
            run_slice(GAT_YAML, "arxiv", "hybrid", vr=True, extra=("dataset=sbm-arxiv",)),
            run_slice(GAT_YAML, "arxiv", "coo-only", vr=False, extra=("dataset=sbm-arxiv",)),
            run_slice(PNA_YAML, "arxiv", "hybrid", vr=False, extra=("dataset=sbm-arxiv",)),
            run_slice(PNA_YAML, "arxiv", "hybrid", vr=True, extra=("dataset=sbm-arxiv",)),
            run_slice(PNA_YAML, "arxiv", "hybrid", vr=True,
                      extra=("dataset=sbm-arxiv", "true_vr=true")),
            run_slice(PNA_YAML, "arxiv", "hybrid", vr=False,
                      extra=("dataset=sbm-arxiv", "model=PNA_JK"))]
    log(f"  phase 4: {time.perf_counter() - t:.1f} s")

    log("phase 5: accuracy, GCN GAS with the accuracy suite's protocol")
    t = time.perf_counter()
    check_accuracy(device)
    log(f"  phase 5: {time.perf_counter() - t:.1f} s")

    log("phase 6: spill, checkpoint, supervise")
    t = time.perf_counter()
    # GCNII products: 5 layers x (500,000 + 1) rows x 128 f32 a cache stack
    stack = 5 * 500_001 * 128 * 4
    spill_runs = [run_slice(GCN2_YAML, "sbm-products-mid", "hybrid", vr=False,
                            extra=("--spill",)),
                  run_slice(GCN2_YAML, "sbm-products-mid", "block", vr=True,
                            extra=("--spill",))]
    check_spill(runs[5], spill_runs[0], "GCNII products hybrid GAS --spill", stack)
    check_spill(runs[4], spill_runs[1], "GCNII products block VR --spill", 2 * stack)
    # PNA true_vr's packed caches (769 columns) through StreamedPulls; its
    # staged rows are as wide, so no memory bound is asserted
    spill_runs.append(run_slice(PNA_YAML, "arxiv", "hybrid", vr=True,
                                extra=("dataset=sbm-arxiv", "true_vr=true", "--spill")))
    check_spill(runs[17], spill_runs[2], "PNA arxiv hybrid VR true_vr --spill")
    runs += spill_runs
    log(f"  phase 6 (a): {time.perf_counter() - t:.1f} s")
    check_checkpoint_supervise()
    log(f"  phase 6: {time.perf_counter() - t:.1f} s")

    log("phase 7: the fused epoch and the global-column refresh")
    t = time.perf_counter()
    table_res, replay_res = [], []
    # GCN arxiv GAS regroups 40 clusters a batch each epoch, and its overflow
    # bucket grows in epoch 1 (78,592 -> 80,512 slots): its first epoch of
    # one shape is epoch 2, so the arxiv runs take three epochs, three times
    # over at the configuration's dropout; the resumes save after the first
    # fused epoch at the configuration's dropout
    for tag, yaml, dataset, overrides, epochs, first_fused in (
            ("GCN arxiv block GAS", GCN_YAML, "sbm-arxiv", ("adj_format=block",), 3, 2),
            ("GCN arxiv hybrid GAS", GCN_YAML, "sbm-arxiv", ("adj_format=hybrid",), 3, 2),
            ("GCN arxiv hybrid VR", GCN_YAML, "sbm-arxiv",
             ("adj_format=hybrid", "vr_update=true"), 3, 1),
            ("GCNII products hybrid GAS", GCN2_YAML, "sbm-products-mid",
             ("adj_format=hybrid",), 2, 0),
            ("GCNII products block VR", GCN2_YAML, "sbm-products-mid",
             ("adj_format=block", "vr_update=true"), 2, 0),
            # PNA arxiv regroups its 40-cluster batches every epoch, as GCN
            # arxiv does; the max form and its backward run in every step
            ("PNA arxiv hybrid GAS", PNA_YAML, "arxiv",
             ("dataset=sbm-arxiv", "adj_format=hybrid"), 3, 2)):
        t_run = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        make = lambda yaml=yaml, dataset=dataset, overrides=overrides: (  # noqa: E731
            make_trainer(yaml, dataset, overrides))
        tr = make()
        log(f"  {tag}: trainer ready [{time.perf_counter() - t_run:.1f} s]")
        arxiv = tag.startswith("GCN arxiv")
        fl = fused_vs_loop(tag, tr, epochs, reps=3 if arxiv else 1)
        runs += fl["runs"]
        if tr.eval_loader.uses_global_cols:
            per_refresh = global_vs_local(tag, tr)["per_refresh"]
            if tag.endswith("GAS"):
                table_res += table_cases(tag, tr, per_refresh)
        if tag in ("GCN arxiv hybrid VR", "GCNII products block VR"):
            fused_resume(tag, tr, fl["start"], make, first_fused)
        if tag == "GCNII products block VR":
            p10_keep_reference(tr, fl["fill"])
        if not arxiv:
            replay_res.append(replay_launches(tag, tr))
            if tag.startswith("PNA") and not all(replay_res[-1]["per_replay"].get(k)
                                                 for k in ("hybrid_max", "hybrid_max_bwd")):
                raise AssertionError(f"{tag}: a replay launched no max form: "
                                     f"{replay_res[-1]['per_replay']}")
        del tr, fl
        log(f"  {tag}: {time.perf_counter() - t_run:.1f} s")
    log(f"  phase 7: {time.perf_counter() - t:.1f} s")

    log("phase 8: datasets on disk, the inductive (PPI) protocol, neighbor sampling")
    t = time.perf_counter()
    runs += inductive_ppi(ppi, card)
    log(f"  phase 8 (a): {time.perf_counter() - t:.1f} s")
    runs.append(ns_reddit(runs[8], card))
    log(f"  phase 8: {time.perf_counter() - t:.1f} s")

    log("phase 9: the refresh sweep as captured CUDA graphs")
    t = time.perf_counter()
    runs += phase_refresh(card, ppi)
    log(f"  phase 9: {time.perf_counter() - t:.1f} s")

    log("phase 10: multi-device training, ranks sharing the card")
    t = time.perf_counter()
    runs += phase_sharded(device, card)
    log(f"  phase 10: {time.perf_counter() - t:.1f} s")

    log("phase 11: sharded GAT and PNA, the sharded spill tier")
    t = time.perf_counter()
    runs += phase_sharded_models(device, card)
    log(f"  phase 11: {time.perf_counter() - t:.1f} s")

    log("phase 12: the pipelined refresh, scaling_bench, --runs, the bf16 spill tier, the gate under torchrun")
    t = time.perf_counter()
    runs += phase_pipelined(device, card)
    log(f"  phase 12: {time.perf_counter() - t:.1f} s")

    src = {"block_spmm": ("incagg_gnn_tpu_torch/csrc/block_spmm.cu",
                          "incagg_gnn_tpu/ops/block.py:488"),
           "ell_spmm": ("incagg_gnn_tpu_torch/csrc/ell_spmm.cu",
                        "incagg_gnn_tpu/ops/pallas_spmm.py:74"),
           "ell_reduce": ("incagg_gnn_tpu_torch/csrc/ell_reduce.cu",
                          "incagg_gnn_tpu/ops/pallas_spmm.py:105"),
           "hybrid_max": ("incagg_gnn_tpu_torch/csrc/ell_max.cu",
                          "incagg_gnn_tpu/ops/ell.py:955 (spmm_hybrid_max with "
                          "_max_tie_count :970; XLA code, not a Pallas kernel)"),
           "hybrid_max_bwd": ("incagg_gnn_tpu_torch/csrc/ell_max.cu",
                              "incagg_gnn_tpu/ops/ell.py:1007 (_spmm_max_bi_bw; XLA "
                              "code, not a Pallas kernel)")}
    kernels = []
    chunk_cols = K.hybrid_max_chunk_cols()
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
            "cases": [{k: r[k] for k in ("case", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", "max_abs_err", "library",
                                         "yardstick_ms", "yardstick", "graph_ms")
                       if k in r} for r in kres[name]],
        }
        if name in REPLAYED:
            # phase 7 (e): replays' launches seen by torch.profiler, by kernel name
            entry["profiled_replays"] = [
                {"case": r["case"], "replays": r["replays"], "seen": r["seen"][name],
                 "per_replay": r["per_replay"].get(name, 0),
                 "graph_nodes": r["graph_nodes"][name]} for r in replay_res]
        if name == "hybrid_max_bwd":
            for e, r in zip(entry["profiled_replays"], replay_res):
                e.update(step_kernels_seen=r["bwd_steps_seen"],
                         step_kernels_per_replay=r["bwd_steps_per_replay"])
        if name == "ell_spmm":
            entry["launches_heads"] = sum(r["counts"]["hybrid_spmm_heads"] for r in runs)
        if name == "hybrid_max":
            entry["note"] = ("no single PyTorch call computes it; yardstick_ms is "
                             "index_select + torch.segment_reduce(max), two calls")
            entry["yardstick_ms"] = main_case["yardstick_ms"]
        if name in chunk_cols:  # the max form's column chunk, read from the library
            entry["chunk_cols"] = chunk_cols[name]
        if name == "ell_reduce":
            if entry["launches"]:
                raise AssertionError("ell_reduce ran on a main path: no path calls it")
            entry["note"] = "no path of either package calls it: 0 main-path launches"
        kernels.append(entry)
    main_case = next(r for r in table_res if r["main"])
    kernels.append({
        "name": "hybrid_spmm_table", "route": "cuda",
        "source": "incagg_gnn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": ("incagg_gnn_tpu/ops/pallas_spmm.py:74 (pallas_spmm_ell_vmem), "
                     "over global columns and a cache table in its storage dtype as "
                     "incagg_gnn_tpu/models/base.py:376 (_refresh_batch_step_global) "
                     "aggregates"),
        "launches": sum(r["counts"]["hybrid_spmm_table"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in table_res),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "case": main_case["case"],
        "cases": [{k: r[k] for k in ("case", "row_type", "ms", "graph_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by", "max_abs_err",
                                     "launches_per_refresh")} for r in table_res],
        "note": "library_ms: torch.sparse.mm in f32 only (no f32-value SpMM over "
                "bf16 or fp8 rows)"})
    log(f"  total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
