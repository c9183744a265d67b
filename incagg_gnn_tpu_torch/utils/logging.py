"""Structured metrics logging and profiling helpers.

Port of ``incagg_gnn_tpu/utils/logging.py``: a JSONL sink for per-epoch
scalars (the trainer's ``train_epoch`` and ``eval`` records), a
``torch.profiler`` trace context, and a wall-clock timer that waits for the
device before it stops.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics sink; one record per event."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        self._t0 = time.time()

    def log(self, kind: str, **scalars: Any) -> Dict[str, Any]:
        rec = {"t": round(time.time() - self._t0, 3), "kind": kind}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace (CPU, and CUDA where present) written as a
    Chrome trace into ``log_dir``; a no-op when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock timer that waits for the devices of the given tensors
    before it stops."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def stop(self, *sync_on) -> float:
        for dev in {a.device for a in sync_on
                    if isinstance(a, torch.Tensor) and a.is_cuda}:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - self.t0
