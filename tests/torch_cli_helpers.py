"""Helpers of the port's CLI tests: run ``python -m incagg_gnn_tpu_torch``
on the CPU at the sbm-tiny size, in a child process or in this one, and
read its metrics JSONL."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: GCN's sbm-small hyperparameters on the sbm-tiny graph, two epochs
ARGS = ["--model", os.path.join(ROOT, "conf/model/gcn.yaml"), "--dataset", "sbm-small",
        "--device", "cpu", "dataset=sbm-tiny", "num_parts=4", "batch_size=2",
        "adj_format=hybrid"]


def run_cli(*args, env=None, timeout=300):
    """Run the port's CLI in a child process; returns (exit code, output)."""
    child_env = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    p = subprocess.run([sys.executable, "-m", "incagg_gnn_tpu_torch", *ARGS, *args],
                       capture_output=True, text=True, env=child_env, cwd=ROOT,
                       timeout=timeout)
    return p.returncode, p.stdout + p.stderr


def records(path, kind):
    """The ``kind`` records of a metrics JSONL file."""
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]
