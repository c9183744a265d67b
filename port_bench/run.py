"""One run of one cell of the port's benchmark.

    python3 -m port_bench.run --workload gcn2-products.reverb --seed 7 --seconds 20 --trace 0

from the root of a checkout.  The cell, its configuration and its traffic
are found by name: ``BENCHMARK.json`` names the cell's configuration file
and traffic, ``port_bench/workloads/<traffic>.json`` holds the traffic,
``port_bench/metrics/<metric>.py`` reads each per-layer metric and
``port_bench/limits/<cell>.json`` holds the limits of the check.

Set-up (``setup_s``): the graph (drawn once per checkout, then loaded
from ``port_bench/.cache/graphs/``), the kernels' build, the port's
``Trainer`` (partition, loaders, formats) with the seed's weights, the
fill (``fill_history``) and ``check.EPOCHS`` epochs (``train_epoch`` +
``evaluate``): the first captures every CUDA graph the cell uses, the
second replays them, and the check compares both.  The window then runs whole epochs, each ``train_epoch()`` and
``evaluate()``, until the first epoch boundary after ``--seconds``.
``--trace 1`` runs the same window under ``torch.profiler`` with a
synchronised span around each call and prints the per-layer metrics.
After the window the port's state is freed and the plain reference
decides ``correct`` (``check.py``).  The last line of standard output is
the result as one JSON object; the last lines of standard error the
compared numbers beside their limits.

The run fails, and prints no result, without a CUDA device (or with
fewer than the cell asks for), and when a module of JAX or of the JAX
package is loaded at the end.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "port_bench", ".cache")


def _fix_caches() -> None:
    """Every cache in fixed directories inside the checkout, before torch
    is imported: the bytecode of the program and of torch (the card's
    Python ships torch without it), Triton's, torch's extensions' and
    CUDA's JIT cache."""
    pyc = os.path.join(CACHE, "pycache")
    sys.pycache_prefix = pyc
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")


_fix_caches()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import check, counts, graphgen, harness  # noqa: E402
from port_bench import trace as tracing  # noqa: E402
from port_bench.weights import make_weights  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "incagg_gnn_tpu")
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _named(entries, name: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_cell(bench: Dict, workload: str):
    """(cell, configuration, traffic) of a cell of ``bench``."""
    cell = _named(bench["workloads"], workload)
    with open(os.path.join(ROOT, _named(bench["configs"], cell["config"])["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "port_bench", "workloads", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _metrics_of(bench: Dict, workload: str, kind: str):
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    return [m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # the tool is missing or failed: say so
        return f"unknown ({type(e).__name__})"


def _work(model, graph, perm, epochs, eval_nodes, vr: bool, loop: bool, pk):
    """Model operations and the aggregations' summed bound over the
    window's epochs: every kept training batch and one refresh an epoch,
    counted from the batches' real rows and entries."""
    rowptr, col, train = graph["rowptr"], graph["col"], graph["train_mask"]
    shapes: Dict[bytes, counts.BatchShape] = {}

    def shape(nodes):
        key = nodes.tobytes()
        if key not in shapes:
            shapes[key] = counts.batch_shape(rowptr, col, nodes, loop)
        return shapes[key]

    eval_shapes = [shape(perm[b]) for b in eval_nodes]
    r_gemm, r_aggs = model.refresh_work(eval_shapes, vr, rowptr.shape[0] - 1)
    flops, bound = 0.0, 0.0
    for batches in epochs:
        for n_id, bs in batches:
            nodes = perm[np.asarray(n_id[:bs])]
            if not train[nodes].any():
                continue
            gemm, fwd, bwd = model.step_work(shape(nodes), vr)
            flops += 3.0 * gemm
            for a in fwd + bwd:
                flops += counts.agg_work(*a)[0]
                bound += counts.agg_bound_s(*a, pk) if pk else 0.0
        flops += r_gemm
        for a in r_aggs:
            flops += counts.agg_work(*a)[0]
            bound += counts.agg_bound_s(*a, pk) if pk else 0.0
    return flops, bound


def setup(bench: Dict, workload: str, seed: int, device, t0: float) -> types.SimpleNamespace:
    """The set-up of a run: the graph, the kernels, the port's trainer with
    the seed's weights, the fill and the checked epochs, what they produced
    recorded (``check.Record``)."""
    device = torch.device(device)
    cell, cfg, traffic = load_cell(bench, workload)
    cuda = device.type == "cuda"
    split = {}

    t = time.perf_counter()
    graph = graphgen.load_graph({**cfg["graph"], **traffic.get("graph", {})},
                                os.path.join(CACHE, "graphs"))
    split["dataset_s"] = time.perf_counter() - t
    t = time.perf_counter()
    split["kernel_build_s"] = harness.build_kernels() if cuda else 0.0
    split["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer, weights = harness.build(cfg, traffic, graph, seed, device,
                                     lambda shapes: make_weights(shapes, seed, device))
    _sync(device)
    split["trainer_s"] = time.perf_counter() - t
    vr = bool(trainer.cfg.vr_update)
    log(f"formats: train {trainer.train_loader.adj_format}, eval "
        f"{trainer.eval_loader.adj_format}; vr_update {vr}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the fill and the checked epochs, what they produced recorded
    tap = harness.Tap(trainer, masks=True)
    perm_t = torch.as_tensor(trainer.perm, device=device)
    v = check.projector([t.shape[1] for t in harness.tables(trainer).values()], seed, device)
    t = time.perf_counter()
    fill_logits = trainer.fill_history()
    _sync(device)
    split["fill_s"] = time.perf_counter() - t
    fill_proj = check.project(torch.from_numpy(fill_logits), v, perm_t)
    del fill_logits
    runs = []
    for e in range(check.EPOCHS):
        t = time.perf_counter()
        tap.new_epoch()
        runs.append(trainer.train_epoch())
        trainer.evaluate()
        _sync(device)
        split[f"epoch{e}_s"] = time.perf_counter() - t
    tap.remove()
    rec = check.Record(
        perm=np.asarray(trainer.perm).copy(), steps=tap.epochs,
        masks=[[m.cpu() for m in ms] for ms in tap.masks],
        fill=fill_proj, loss=float(runs[0]["loss"]),
        step_losses=[[float(x) for x in ls] for ls in tap.losses],
        all_steps=not (cuda and any(tr.get("fused") for tr in runs)),
        after={k: p.detach().cpu().clone() for k, p in trainer.model.named_parameters()},
        exp_avg=harness.exp_avg(trainer),
        tables={k: check.project(t, v, perm_t) for k, t in harness.tables(trainer).items()})
    del tap
    plan = getattr(trainer.model, "_last_refresh_plan", {})
    log("checked epochs: fused " + ", ".join(
        f"{tr.get('fused')} ({tr.get('reason') or 'no reason'})" for tr in runs)
        + f"; refresh {plan.get('mechanism')}, captures {plan.get('captures')}")
    _sync(device)
    setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")
    return types.SimpleNamespace(trainer=trainer, weights=weights, rec=rec, v=v, graph=graph,
                                 cfg=cfg, traffic=traffic, vr=vr, setup_s=setup_s)


def reference_of(s: types.SimpleNamespace, device, **kw):
    """The plain reference of a set-up's cell (``kw``: a fault or TF32)."""
    from port_bench.reference.train import Reference

    cfg = {**s.cfg, "trainer": {**s.cfg["trainer"], **s.traffic.get("trainer", {})}}
    return Reference(s.graph, cfg, s.vr, s.weights, device, **kw)


def free_program(s: types.SimpleNamespace, device) -> None:
    """Drop the port's trainer and return its memory."""
    s.trainer = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device,
             limits: Optional[Dict[str, float]] = None, t0: Optional[float] = None) -> Dict:
    """One run of ``workload``; returns the result object."""
    from port_bench.reference.train import load_model

    device = torch.device(device)
    cuda = device.type == "cuda"
    if limits is None:
        limits = check.load_limits(ROOT, workload)
    s = setup(bench, workload, seed, device, T0 if t0 is None else t0)
    trainer, graph, cfg, vr = s.trainer, s.graph, s.cfg, s.vr

    # the window
    wtap = harness.Tap(trainer, masks=False) if trace else None
    spans = {"train_epoch": [], "evaluate": []}
    epochs = []
    l0 = harness.launches()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    _sync(device)
    tw = time.perf_counter()
    with (torch.profiler.record_function("bench.window") if trace
          else contextlib.nullcontext()):
        while True:
            if trace:
                wtap.new_epoch()
                t = time.perf_counter()
                with torch.profiler.record_function("bench.train_epoch"):
                    tr = trainer.train_epoch()
                    _sync(device)
                spans["train_epoch"].append(time.perf_counter() - t)
                t = time.perf_counter()
                with torch.profiler.record_function("bench.evaluate"):
                    trainer.evaluate()
                    _sync(device)
                spans["evaluate"].append(time.perf_counter() - t)
            else:
                tr = trainer.train_epoch()
                trainer.evaluate()
            epochs.append(tr)
            if time.perf_counter() - tw >= seconds:
                break
        _sync(device)
    window_s = time.perf_counter() - tw
    looped = [(i, e.get("reason")) for i, e in enumerate(epochs) if not e.get("fused")]
    log(f"window: {len(epochs)} epochs in {window_s:.3f} s; not fused: {looped or 'none'}")
    if prof is not None:
        prof.__exit__(None, None, None)
    l1 = harness.launches()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    n_ep = len(epochs)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    result = {"correct": False, "attempted": n_ep, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    e2e = {"epoch_s": window_s / n_ep, "setup_s": s.setup_s,
           "peak_device_mem": peak / GIB, "peak_host_mem": host_peak / GIB}
    if not trace:
        for m in _metrics_of(bench, workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        pk = counts.peaks(name)
        model = load_model(cfg, graph["x"].shape[1],
                           int(graph["y"].max()) + 1, graph["rowptr"])
        flops, bound = _work(model, graph, np.asarray(trainer.perm), wtap.epochs,
                             harness.eval_batches(trainer), vr, bool(trainer.cfg.loop), pk)
        wtap.remove()
        del wtap
        summary = tracing.summarize(prof, window_name="bench.window")
        ctx = types.SimpleNamespace(
            spans=spans, epochs=epochs, n_epochs=n_ep, window_s=window_s,
            launches={k: l1[k] - l0[k] for k in l1}, trace=summary, flops=flops,
            agg_bound_s=bound, peaks=pk, cache_bytes=harness.cache_bytes(trainer),
            device_name=name)
        for m in _metrics_of(bench, workload, "per_layer"):
            val = importlib.import_module(f"port_bench.metrics.{m['name']}").read(ctx)
            if val is not None:
                result["metrics"][m["name"]] = {"value": val, "unit": m["unit"]}
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
        if cuda:
            log(f"card: {_power_limit()}")
        del prof, summary, ctx

    # the port's state freed, then the reference
    del trainer
    free_program(s, device)
    t = time.perf_counter()
    ref = reference_of(s, device)
    values = check.compare(s.rec, check.follow(ref, s.rec, s.v), ref.model.leaves, s.weights)
    log(f"check: reference {time.perf_counter() - t:.3f} s")
    result["correct"] = check.verdict(values, limits)
    result["compared"] = {k: {"value": values[k], "limit": limits.get(k)}
                          for k in check.NUMBERS}
    return result


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = _named(bench["workloads"], args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"port_bench: the cell needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    # the reference multiplies in full f32, as the configurations state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda:0"))
    found = loaded_forbidden()
    if found:
        log(f"port_bench: modules of {', '.join(found)} are loaded; no result")
        return 3
    for k, c in result["compared"].items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
