"""The reduction of a ``torch.profiler`` trace of the measured window: the
device's busy seconds (the union of the intervals in which a kernel, copy
or fill ran, never their sum), the device time by operation name, and the
longest idle gaps named by what the host was doing in them (the host
event that overlaps the gap most).  The benchmark's own annotations
(``record_function`` names starting with ``bench.``), which the profiler
also draws on the device's timeline, are no device work."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

#: entries of each breakdown list
TOP = 10
#: the prefix of the benchmark's own annotations
OWN = "bench."


class TraceSummary(NamedTuple):
    busy_s: float
    window_s: float
    op_s: Dict[str, float]  # device seconds by operation name
    device_ops: List[list]  # the TOP operations by device seconds
    idle_gaps: List[list]  # the TOP idle gaps: [what the host did, seconds]


def _events(prof):
    """(device intervals, host intervals) in ns: arrays of start, end and
    the names."""
    dev_t, host_t, dev_n, host_n = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name().startswith(OWN):
                continue
            dev_t.append((start, end))
            dev_n.append(e.name())
        else:
            host_t.append((start, end))
            host_n.append(e.name())
    return (np.array(dev_t, dtype=np.int64).reshape(-1, 2), dev_n,
            np.array(host_t, dtype=np.int64).reshape(-1, 2), host_n)


def _union(iv: np.ndarray) -> np.ndarray:
    """The union of intervals, as disjoint sorted intervals."""
    if iv.size == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
    starts = iv[new, 0]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return np.stack([starts, ends], axis=1)


def summarize(prof, window_name: Optional[str] = None) -> TraceSummary:
    """The summary of ``prof`` over the host event ``window_name`` (a
    ``record_function`` around the window), by default from the first to
    the last event."""
    dev, dev_n, host, host_n = _events(prof)
    window = None
    if window_name is not None and window_name in host_n:
        k = host_n.index(window_name)
        window = (int(host[k, 0]), int(host[k, 1]))
    if window is None:
        allt = np.concatenate([dev, host]) if host.size else dev
        window = (int(allt[:, 0].min()), int(allt[:, 1].max())) if allt.size else (0, 0)
    lo, hi = window
    op_s: Dict[str, float] = {}
    for (s, e), name in zip(dev, dev_n):
        d = min(e, hi) - max(s, lo)
        if d > 0:
            op_s[name] = op_s.get(name, 0.0) + d * 1e-9
    busy = _union(np.clip(dev, lo, hi)) if dev.size else dev
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum()) if busy.size else 0
    # idle gaps: between busy intervals, and at the window's edges
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2) if busy.size else \
        np.array([[lo, hi]], dtype=np.int64)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    order = np.argsort(gaps[:, 1] - gaps[:, 0])[::-1][:TOP]
    idle = []
    others = np.array([not n.startswith(OWN) for n in host_n], dtype=bool)
    for s, e in gaps[order]:
        label = "no host event"
        if host.size:
            overlap = np.minimum(host[:, 1], e) - np.maximum(host[:, 0], s)
            overlap = np.where(others, overlap, 0)
            k = int(np.argmax(overlap))
            if overlap[k] > 0:
                label = host_n[k]
        idle.append([label, float((e - s) * 1e-9)])
    top = sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy_s=busy_ns * 1e-9, window_s=(hi - lo) * 1e-9, op_s=op_s,
                        device_ops=[[k, v] for k, v in top], idle_gaps=idle)
