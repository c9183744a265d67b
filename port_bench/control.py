"""Readings of the check's numbers for its limits: the program's sound runs,
the control and the planted faults, at a cell's own size, over several
seeds in one process.  The benchmark's own runs never run this.

    python3 -m port_bench.control --workload gcn2-products.reverb --seeds 11 12 13 \\
        [--modes tf32 half_batch alter frozen] [--out control.json]

For each seed: the run's set-up (the port's fill and checked epochs,
recorded), the port freed, the plain reference followed once in f32;
then the numbers of the program, and of the reference put in the
program's place with each mode: ``tf32`` (the control: every matrix
product in TF32, the precision below the configuration's f32),
``half_batch`` (the loss over half of each batch's train rows),
``alter`` (two rows of the refreshed logits swapped) and ``frozen`` (no
optimizer update).  One JSON line a seed, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from port_bench import run  # fixes the caches before torch is imported

import torch  # noqa: E402

from port_bench import check  # noqa: E402

MODES = {"tf32": {"tf32": True}, "half_batch": {"fault": "half_batch"},
         "alter": {"fault": "alter"}, "frozen": {"fault": "frozen"}}


def readings(bench, workload: str, seed: int, modes, device) -> dict:
    t0 = time.perf_counter()
    s = run.setup(bench, workload, seed, device, t0)
    run.free_program(s, device)
    ref = run.reference_of(s, device)
    base = check.follow(ref, s.rec, s.v)
    detail = {}
    leaves = ref.model.leaves
    del ref
    out = {"seed": seed, "program": check.compare(s.rec, base, leaves, s.weights, detail),
           "detail": {"program": detail}}
    for mode in modes:
        ctrl = run.reference_of(s, device, **MODES[mode])
        crec = check.as_record(ctrl, s.rec, s.v)
        del ctrl
        detail = {}
        out[mode] = check.compare(crec, base, leaves, s.weights, detail)
        out["detail"][mode] = detail
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="*", default=list(MODES), choices=list(MODES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    rows = []
    for seed in args.seeds:
        rows.append(readings(bench, args.workload, seed, args.modes, torch.device("cuda:0")))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                       "readings": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
