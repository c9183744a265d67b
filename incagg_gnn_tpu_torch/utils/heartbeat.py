"""Liveness heartbeat for supervisor-level stall recovery.

Port of ``incagg_gnn_tpu/utils/heartbeat.py``.  The in-process watchdog
(``utils/watchdog.py``) can only bound a wait on work that was queued; a
call that wedges inside the runtime or the driver never returns anything to
wait on.  The only reliable recovery is at the process level: the trainer
touches a heartbeat file at progress points (between steps and refresh
batches), and the ``--supervise`` parent kills and restarts the child from
its newest checkpoint when the heartbeat goes stale (``__main__.py``).

``beat()`` is a no-op unless the supervisor set ``INCAGG_HEARTBEAT_FILE``,
and is throttled so hot loops pay one ``os.utime`` per second at most.
"""

from __future__ import annotations

import os
import time

ENV_VAR = "INCAGG_HEARTBEAT_FILE"
_last = 0.0


def beat(min_interval_s: float = 1.0) -> None:
    """Touch the supervisor's heartbeat file (throttled; never raises)."""
    global _last
    path = os.environ.get(ENV_VAR)
    if not path:
        return
    now = time.monotonic()
    if now - _last < min_interval_s:
        return
    _last = now
    try:
        with open(path, "a"):
            pass
        os.utime(path, None)
    except OSError:
        pass
