"""Background-thread batch prefetching.

Port of ``incagg_gnn_tpu/utils/prefetch.py``.  The shuffled train loader
re-collates batches on the host every epoch (relabel, hybrid or tile
build, padding); iterating it on a daemon thread overlaps that host work,
and the loader's pinned, non-blocking staging to the device
(``loader.py``), with the device's steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_ITEM, _ERROR, _END = range(3)


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items
    ready.  An exception raised by ``it`` is raised again in the consumer.
    When the consumer stops early (``break``, an exception, ``close()``),
    the worker stops at its next item, closes ``it`` and is joined; the
    items it had queued are dropped."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(kind, item) -> bool:
        while not stop.is_set():
            try:
                q.put((kind, item), timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        source = iter(it)
        try:
            for item in source:
                if not put(_ITEM, item):
                    return
        except BaseException as e:  # raised again in the consumer
            put(_ERROR, e)
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
            put(_END, None)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            kind, item = q.get()
            if kind == _END:
                return
            if kind == _ERROR:
                raise item
            yield item
    finally:
        stop.set()
        t.join()
        while not q.empty():  # release what the worker staged ahead
            q.get_nowait()
