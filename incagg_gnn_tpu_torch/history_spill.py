"""Host-memory history caches (the spill tier).

Port of ``incagg_gnn_tpu/history_spill.py``.  When the caches outgrow the
device, each layer's ``[N+1, D]`` table lives in host memory and rows move
to and from the device per batch — the reference's pinned-CPU histories and
async copy pool (its history.py:17-18, pool.py:15-134), on their native
ground here:

- a C++ worker thread (``csrc/spill.cpp``, shared with the JAX package)
  gathers and scatters rows between the table and per-slot staging buffers,
  one job at a time in submission order (FIFO), as the reference's pool;
- on CUDA the table and the staging slots are **pinned**, and the staged
  rows go to the device with ``non_blocking`` copies on a copy stream, each
  followed by an event.

Usage mirrors the pool: ``async_pull`` → ``synchronize_pull`` →
``free_pull``, and ``async_push`` → ``synchronize_push``.

Ordering rules the class keeps:

- a pull's host-to-device copy reads its staging slot asynchronously, so
  the slot's event is waited on before the worker gathers into it again;
- a push copies device rows into a pinned buffer and waits for that copy's
  event *before* it queues the scatter — a scatter queued behind an
  unfinished copy would write stale bytes into the table without any error;
- every job runs on the one FIFO worker, so a pull queued after a push
  reads the pushed rows.

The single-device spill trainer keeps float32 tables whatever its
``hist_dtype`` (as in the JAX package); the sharded one keeps them in the
cache dtype (``dtype``), each row padded to whole 4-byte words, which the
worker copies.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from incagg_gnn_tpu_torch.utils.native import BUILD_DIR, _build

_SRC = os.path.join(os.path.dirname(BUILD_DIR), "csrc", "spill.cpp")
_SO = os.path.join(BUILD_DIR, "libincagg_spill.so")
_LOCK = threading.Lock()
_DLL: Optional[ctypes.CDLL] = None

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def spill_lib() -> ctypes.CDLL:
    """The spill worker library, built from ``csrc/spill.cpp`` into the
    git-ignored ``build/`` on first use (the port requires it)."""
    global _DLL
    if _DLL is None:
        with _LOCK:
            if _DLL is None:
                _build(_SRC, _SO)
                dll = ctypes.CDLL(_SO)
                dll.spill_gather_async.argtypes = [
                    _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _f32p, ctypes.c_int64]
                dll.spill_scatter_chunks_async.argtypes = [
                    _f32p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _f32p,
                    ctypes.c_int64]
                dll.spill_scatter_async.argtypes = [
                    _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _f32p, ctypes.c_int64]
                dll.spill_wait.argtypes = [ctypes.c_int64]
                for fn in (dll.spill_gather_async, dll.spill_scatter_chunks_async,
                           dll.spill_scatter_async, dll.spill_wait):
                    fn.restype = None
                _DLL = dll
    return _DLL


#: the worker's slot ids are per process (one worker): each table takes
#: ``2 * pool_size`` of them, its pulls' then its pushes'.  Two tables that
#: share an id after the wrap only wait for each other's jobs as well.
_SLOT_LOCK = threading.Lock()
_next_slot_base = 0
_MAX_SLOTS = 1024  # the worker's slot table (csrc/spill.cpp)


def _take_slots(n: int) -> int:
    global _next_slot_base
    with _SLOT_LOCK:
        base = _next_slot_base
        if base + n > _MAX_SLOTS:
            base = 0
        _next_slot_base = base + n
    return base


class SpilledHistory:
    """One host-resident ``[num_nodes+1, dim]`` cache layer of ``dtype``
    (float32 by default) with an async pull/push pool of ``pool_size``
    slots of ``buffer_size`` rows each (the reference's History +
    AsyncIOPool); a slot grows when a pull or a push needs more rows.

    A narrower ``dtype`` stores each row in ``cols`` >= ``dim`` columns, a
    whole number of 4-byte words; pulled rows have ``cols`` columns of
    ``dtype``, pushed values are converted to it.

    ``device``: where pulled rows go (CUDA: pinned table and slots, copies
    on ``copy_stream``, by default a stream of this table's own).
    ``debug_verify``: after each pull's gather completes, assert that it
    matches a synchronous gather (the spill tier's concurrency check)."""

    def __init__(self, num_nodes: int, dim: int, pool_size: int = 2,
                 buffer_size: int = 65536, device="cpu",
                 debug_verify: bool = False,
                 copy_stream: Optional["torch.cuda.Stream"] = None,
                 dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self.dtype = dtype
        self.itemsize = torch.empty((), dtype=dtype).element_size()
        per_word = 4 // self.itemsize
        self.cols = -(-dim // per_word) * per_word
        self.words = self.cols * self.itemsize // 4  # a row as the worker sees it
        self.table_t = torch.zeros((num_nodes + 1, self.cols), dtype=dtype,
                                   pin_memory=self._pin)
        # the same memory as [rows, words] float32, for the worker
        self.table = self.table_t.view(torch.float32).numpy()
        self.dim = dim
        self.pool_size = pool_size
        self.buffer_size = buffer_size
        self.debug_verify = debug_verify
        self._dll = spill_lib()
        self._base = _take_slots(2 * pool_size)
        self._stream = copy_stream
        if self._pin and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # pull slots: staging rows, and the event after the copy out of them
        self._staging_t = [self._host(buffer_size) for _ in range(pool_size)]
        self._slot_free: List[Optional[torch.cuda.Event]] = [None] * pool_size
        self._queue: List[tuple] = []  # (slot, rows, idx) of in-flight pulls
        self._next_slot = 0
        # push slots: pinned sources the worker reads until it has scattered
        self._push_t = [self._host(buffer_size) for _ in range(pool_size)]
        self._push_keep: List[Optional[tuple]] = [None] * pool_size
        self._push_seq = 0
        self.bytes_h2d = 0
        self.bytes_d2h = 0

    def _host(self, rows: int) -> torch.Tensor:
        return torch.empty((rows, self.cols), dtype=self.dtype, pin_memory=self._pin)

    @staticmethod
    def _words(t: torch.Tensor) -> np.ndarray:
        """``t``'s memory as the float32 words the worker copies."""
        return t.view(torch.float32).numpy()

    def _stored(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` ``[rows, dim]`` as stored rows: ``dtype``, ``cols``
        columns (on their own device)."""
        if values.dtype == self.dtype and values.shape[1] == self.cols:
            return values
        out = values.new_zeros((values.shape[0], self.cols), dtype=self.dtype)
        out[:, : self.dim] = values.to(self.dtype)
        return out

    # ---------------- pull ----------------
    def async_pull(self, idx) -> None:
        """Start gathering rows ``idx`` into the next staging slot on the
        worker (pool.py:64-81)."""
        assert len(self._queue) < self.pool_size, "pull pool exhausted"
        slot = self._next_slot
        self._next_slot = (slot + 1) % self.pool_size
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        n = idx.shape[0]
        if self._slot_free[slot] is not None:
            # the slot's last host-to-device copy may still be reading it
            self._slot_free[slot].synchronize()
            self._slot_free[slot] = None
        if n > self._staging_t[slot].shape[0]:
            self._staging_t[slot] = self._host(n)
        self._dll.spill_gather_async(self.table, self.words, idx, n,
                                     self._words(self._staging_t[slot]), self._base + slot)
        self._queue.append((slot, n, idx))  # idx stays alive for the worker

    def synchronize_pull(self, out: Optional[torch.Tensor] = None,
                         wait: bool = True) -> torch.Tensor:
        """The rows of the oldest in-flight pull on ``device`` (pool.py:83-88),
        ``[rows, cols]`` of ``dtype``, copied into ``out`` (of that shape
        and dtype) when given.  On CUDA the copy
        runs on the copy stream, so ``out`` must have been allocated or
        last written there; with ``wait`` the current stream waits for the
        copy, else the caller orders its stream after the copy stream."""
        slot, n, idx = self._queue[0]
        self._dll.spill_wait(self._base + slot)
        src = self._staging_t[slot][:n]
        if self.debug_verify:
            assert np.array_equal(self._words(src), self.table[idx]), (
                "spill pull mismatch vs synchronous gather (slot reuse race?)")
        self.bytes_h2d += src.numel() * self.itemsize
        if not self._pin:
            if out is None:
                return src.clone()
            return out.copy_(src)
        with torch.cuda.stream(self._stream):
            if out is None:
                out = torch.empty((n, self.cols), dtype=self.dtype, device=self.device)
            out.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slot_free[slot] = event
        if wait:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            out.record_stream(cur)
        return out

    def free_pull(self) -> None:
        """Retire the oldest pull slot (pool.py:90-99)."""
        self._queue.pop(0)

    # ---------------- push ----------------
    def async_push(self, values, offset=None, count=None, idx=None) -> None:
        """Write ``values`` (``[rows, dim]`` on the device or the host,
        converted to ``dtype``) back to host rows: chunk-contiguous through
        (``offset``, ``count``), the reference's fast path
        (history.py:60-65), or indexed through ``idx``.  Returns once the
        rows are in a pinned buffer; the scatter into the table runs on the
        worker."""
        values = self._stored(torch.as_tensor(values))
        n = values.shape[0]
        k = self._push_seq % self.pool_size
        self._push_seq += 1
        slot = self._base + self.pool_size + k
        self._dll.spill_wait(slot)  # the buffer's last scatter has read it
        if n > self._push_t[k].shape[0]:
            self._push_t[k] = self._host(n)
        buf = self._push_t[k][:n]
        if values.is_cuda:
            self._stream.wait_stream(torch.cuda.current_stream(values.device))
            with torch.cuda.stream(self._stream):
                buf.copy_(values, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            event.synchronize()  # the scatter must not read before the copy
        else:
            buf.copy_(values)
        self.bytes_d2h += buf.numel() * self.itemsize
        src = self._words(buf)
        if offset is not None:
            offset = np.ascontiguousarray(offset, dtype=np.int64)
            count = np.ascontiguousarray(count, dtype=np.int64)
            self._push_keep[k] = (offset, count)  # alive for the worker
            self._dll.spill_scatter_chunks_async(self.table, self.words, offset, count,
                                                 len(offset), src, slot)
        else:
            idx = np.ascontiguousarray(idx, dtype=np.int64)
            self._push_keep[k] = (idx,)
            self._dll.spill_scatter_async(self.table, self.words, idx, len(idx), src,
                                          slot)

    def synchronize_push(self) -> None:
        """Block until every queued scatter has landed in the table."""
        for k in range(self.pool_size):
            self._dll.spill_wait(self._base + self.pool_size + k)
            self._push_keep[k] = None

    def __del__(self) -> None:
        # the worker must not gather from or scatter into freed memory
        if getattr(self, "_dll", None) is not None:
            for k in range(2 * self.pool_size):
                self._dll.spill_wait(self._base + k)

    def push_table(self, values: torch.Tensor) -> None:
        """Overwrite the whole table with ``values`` (``[num_nodes+1, dim]``,
        on the device or the host, converted to ``dtype``); returns once the
        table holds them.  On CUDA the copy runs on the copy stream after
        the work queued so far on the current stream."""
        assert not self._queue, "a pull is in flight"
        self.synchronize_push()  # no scatter may land after this copy
        values = self._stored(values)
        if values.is_cuda:
            self._stream.wait_stream(torch.cuda.current_stream(values.device))
            with torch.cuda.stream(self._stream):
                self.table_t.copy_(values, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            values.record_stream(self._stream)
            event.synchronize()
        else:
            self.table_t.copy_(values)
        self.bytes_d2h += self.table_t.numel() * self.itemsize
