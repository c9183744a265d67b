"""Device watchdog: fail fast when queued device work stalls.

Port of ``incagg_gnn_tpu/utils/watchdog.py``.  A deadline on the wait for a
train step's results: past ``warn_fraction`` of it the watchdog logs the
stall, past the whole of it it raises :class:`DeviceTimeoutError`, so a
wedged device kills the run loudly (and, under ``--supervise``, restarts it
from its newest checkpoint) instead of hanging it.

Usage (gated by ``TrainerConfig.device_timeout_s``; 0 disables)::

    wd = Watchdog(timeout_s=120.0)
    metrics = wd.wait(metrics, label="train step 12")

On CUDA the wait is for an event recorded on the current stream when
``wait`` is called, after the work that produces the tensors; tensors on
the CPU are ready when they exist.  The blocked ``Event.synchronize`` cannot
be interrupted from Python, so a worker thread waits on it and is abandoned
on timeout.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)


class DeviceTimeoutError(RuntimeError):
    """Queued device work exceeded the watchdog deadline."""


def _cuda_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first CUDA tensor of a dict/list/tuple tree, or None."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.is_cuda else None
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        t = _cuda_tensor(v)
        if t is not None:
            return t
    return None


def _ready_marker(tree: Any) -> Optional[torch.cuda.Event]:
    """An event recorded now on the current stream of the tree's CUDA
    device (it completes after all work queued so far), or None off CUDA."""
    t = _cuda_tensor(tree)
    if t is None:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return event


def _block(marker: Optional[torch.cuda.Event]) -> None:
    """Block until ``marker`` has completed."""
    if marker is not None:
        marker.synchronize()


class Watchdog:
    """Deadline-enforced wait for device work, with stall diagnostics.

    ``warn_fraction``: log a warning (elapsed time and label) when a wait
    crosses this fraction of the deadline.

    The worker is a **daemon** thread: if the deadline fires while it is
    still blocked, the raise must be able to end the process; a non-daemon
    worker would be joined at interpreter shutdown and hang the exit."""

    def __init__(self, timeout_s: float, warn_fraction: float = 0.5):
        self.timeout_s = float(timeout_s)
        self.warn_fraction = warn_fraction
        self._tasks: Optional[queue.Queue] = None
        self._done: Optional[queue.Queue] = None
        self.stalls = 0  # warn-level stalls survived

    def _ensure_worker(self):
        if self._tasks is None:
            self._tasks = queue.Queue()
            self._done = queue.Queue()

            def run(tasks, done):
                while True:
                    marker = tasks.get()
                    try:
                        _block(marker)
                        done.put((True, None))
                    except BaseException as e:  # surface device errors too
                        done.put((False, e))

            threading.Thread(target=run, args=(self._tasks, self._done),
                             name="device-watchdog", daemon=True).start()

    def wait(self, tree: Any, label: str = "") -> Any:
        """Return ``tree`` once the device work queued so far has completed,
        or raise :class:`DeviceTimeoutError` after ``timeout_s``."""
        marker = _ready_marker(tree)
        if self.timeout_s <= 0:
            _block(marker)
            return tree
        self._ensure_worker()
        self._tasks.put(marker)
        warn_at = self.timeout_s * self.warn_fraction
        t0 = time.monotonic()
        warned = False
        while True:
            elapsed = time.monotonic() - t0
            budget = (warn_at if not warned else self.timeout_s) - elapsed
            try:
                ok, err = self._done.get(timeout=max(budget, 0.01))
                if not ok:
                    raise err
                return tree
            except queue.Empty:
                elapsed = time.monotonic() - t0
                if not warned and elapsed >= warn_at:
                    warned = True
                    self.stalls += 1
                    log.warning(
                        "device watchdog: %s still blocking after %.1fs "
                        "(deadline %.1fs) — device=%s",
                        label or "device wait", elapsed, self.timeout_s,
                        _device_summary())
                    continue
                if elapsed >= self.timeout_s:
                    # abandon the blocked daemon worker (it cannot block exit)
                    self._tasks = self._done = None
                    raise DeviceTimeoutError(
                        f"device wait {label or ''} exceeded "
                        f"{self.timeout_s:.1f}s (elapsed {elapsed:.1f}s); "
                        f"device={_device_summary()} — failing fast rather "
                        f"than continuing on a wedged device")


def _device_summary() -> str:
    try:
        if not torch.cuda.is_available():
            return "cpu"
        i = torch.cuda.current_device()
        return (f"cuda:{i} {torch.cuda.get_device_name(i)} "
                f"x{torch.cuda.device_count()}")
    except Exception as e:  # diagnostics must never mask the stall itself
        return f"<unavailable: {e}>"
