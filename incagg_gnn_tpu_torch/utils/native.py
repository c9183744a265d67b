"""ctypes binding to the repository's native C++ graph kernels
(``csrc/graph_ops.cpp``, shared with the JAX package) and to the port's own
host source ``incagg_gnn_tpu_torch/csrc/tile_csr.cpp`` (the dense tier's
tile-CSR build).

The libraries are compiled with ``g++`` on first use into the git-ignored
``build/`` directory at the repository root; nothing is written next to the
sources.  The port requires them: relabel, partition and the ELL/tile
builders call them directly (the JAX package keeps numpy fallbacks as its
test oracle).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional["NativeGraphLib"] = None

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "graph_ops.cpp")
_TILE_SRC = os.path.join(_ROOT, "incagg_gnn_tpu_torch", "csrc", "tile_csr.cpp")
BUILD_DIR = os.path.join(_ROOT, "build")
_SO = os.path.join(BUILD_DIR, "libincagg_graph.so")
_TILE_SO = os.path.join(BUILD_DIR, "libincagg_tile_csr.so")

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _build(src: str, so: str) -> None:
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent test workers may
    # race to build, and a reader must never dlopen a half-written file
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
         src, "-o", tmp],
        capture_output=True, text=True, timeout=240,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
    os.replace(tmp, so)


class NativeGraphLib:
    def __init__(self, dll: ctypes.CDLL, tile_dll: ctypes.CDLL):
        self._dll = dll
        self._tile_dll = tile_dll
        tile_dll.tile_csr_fill.restype = ctypes.c_int64
        tile_dll.tile_csr_fill.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
            ctypes.c_int32, _i32p, _i32p, _f32p, _i32p, ctypes.c_void_p, _i64p,
        ]
        dll.relabel_one_hop.restype = ctypes.c_int64
        dll.relabel_one_hop.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, _i64p,
            ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i32p,
            ctypes.c_void_p, _i64p,
        ]
        dll.relabel_one_hop_within_batch.restype = ctypes.c_int64
        dll.relabel_one_hop_within_batch.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, _i64p,
            ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i32p,
            ctypes.c_void_p,
        ]
        for fn in (dll.partition, dll.partition_multilevel):
            fn.restype = None
            fn.argtypes = [
                _i64p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_uint64, _i64p,
            ]
        dll.sample_neighbors.restype = ctypes.c_int64
        dll.sample_neighbors.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, _i64p, _i32p, ctypes.c_void_p,
        ]
        dll.csr_to_ell.restype = ctypes.c_int64
        dll.csr_to_ell.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            _i32p, _f32p, _i32p, _i32p, _f32p, ctypes.c_int64,
        ]
        dll.blocks_count.restype = ctypes.c_int64
        dll.blocks_count.argtypes = [
            _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _i64p, _i64p,
        ]
        dll.transpose_csr.restype = None
        dll.transpose_csr.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            _i64p, _i32p, ctypes.c_void_p,
        ]
        dll.csr_to_ell_t.restype = ctypes.c_int64
        dll.csr_to_ell_t.argtypes = [
            _i64p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, _i32p, _f32p, _i32p, _i32p, _f32p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        # the relabel scratch, one per thread: a prefetch thread collates
        # while the main thread may collate another loader's batches
        self._local = threading.local()

    def _scratch(self, n: int) -> np.ndarray:
        node_map = getattr(self._local, "node_map", None)
        if node_map is None or node_map.shape[0] < n:
            node_map = self._local.node_map = np.full(n, -1, dtype=np.int64)
        return node_map

    @staticmethod
    def _fptr(a: Optional[np.ndarray]):
        if a is None:
            return None
        return a.ctypes.data_as(ctypes.c_void_p)

    def relabel_one_hop(self, rowptr, col, value, idx):
        num_idx = idx.shape[0]
        n = rowptr.shape[0] - 1
        nnz = int((rowptr[idx + 1] - rowptr[idx]).sum())
        out_rowptr = np.empty(num_idx + 1, dtype=np.int64)
        out_col = np.empty(nnz, dtype=np.int32)
        out_value = np.empty(nnz, dtype=np.float32) if value is not None else None
        out_n_id = np.empty(num_idx + nnz, dtype=np.int64)
        node_map = self._scratch(n)
        total = self._dll.relabel_one_hop(
            rowptr, col, self._fptr(value), np.ascontiguousarray(idx, dtype=np.int64),
            num_idx, n, node_map, out_rowptr, out_col, self._fptr(out_value), out_n_id,
        )
        return out_rowptr, out_col, out_value, out_n_id[:total]

    def relabel_one_hop_within_batch(self, rowptr, col, value, idx):
        num_idx = idx.shape[0]
        n = rowptr.shape[0] - 1
        nnz = int((rowptr[idx + 1] - rowptr[idx]).sum())
        out_rowptr = np.empty(num_idx + 1, dtype=np.int64)
        out_col = np.empty(nnz, dtype=np.int32)
        out_value = np.empty(nnz, dtype=np.float32) if value is not None else None
        node_map = self._scratch(n)
        kept = self._dll.relabel_one_hop_within_batch(
            rowptr, col, self._fptr(value), np.ascontiguousarray(idx, dtype=np.int64),
            num_idx, n, node_map, out_rowptr, out_col, self._fptr(out_value),
        )
        out_col = out_col[:kept]
        if out_value is not None:
            out_value = out_value[:kept]
        return out_rowptr, out_col, out_value, np.ascontiguousarray(idx, dtype=np.int64)

    def sample_neighbors(self, rowptr, col, value, num_neighbors, seed):
        """Each row's entries capped at ``num_neighbors``, drawn uniformly
        without replacement (``mt19937_64`` seeded with ``seed``) and kept
        in their order; returns the compacted ``(rowptr, col, value)``."""
        rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
        col = np.ascontiguousarray(col, dtype=np.int32)
        if value is not None:
            value = np.ascontiguousarray(value, dtype=np.float32)
        num_rows = rowptr.shape[0] - 1
        nnz = col.shape[0]
        out_rowptr = np.empty(num_rows + 1, dtype=np.int64)
        out_col = np.empty(nnz, dtype=np.int32)
        out_value = np.empty(nnz, dtype=np.float32) if value is not None else None
        kept = self._dll.sample_neighbors(
            rowptr, col, self._fptr(value), num_rows, num_neighbors, seed,
            out_rowptr, out_col, self._fptr(out_value),
        )
        out_col = out_col[:kept]
        if out_value is not None:
            out_value = out_value[:kept]
        return out_rowptr, out_col, out_value

    def partition(self, rowptr, col, num_parts, refine_passes, seed,
                  multilevel=False):
        n = rowptr.shape[0] - 1
        out = np.empty(n, dtype=np.int64)
        fn = self._dll.partition_multilevel if multilevel else self._dll.partition
        fn(rowptr, col, n, num_parts, refine_passes, seed, out)
        return out

    @staticmethod
    def _ell_buffers(rows_alloc, k, trash_col, ovf_alloc, ovf_row_fill):
        """Padded output buffers the C++ writes into (pad slots pre-set to
        trash column / zero value)."""
        ell_cols = np.full((rows_alloc, k), trash_col, dtype=np.int32)
        ell_vals = np.zeros((rows_alloc, k), dtype=np.float32)
        ovf_rows = np.full(ovf_alloc, ovf_row_fill, dtype=np.int32)
        ovf_cols = np.full(ovf_alloc, trash_col, dtype=np.int32)
        ovf_vals = np.zeros(ovf_alloc, dtype=np.float32)
        return ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals

    def csr_to_ell(self, rowptr, col, value, k, trash_col, ovf_cap,
                   rows_alloc=None, ovf_row_fill=0):
        """ELL slabs + COO overflow from CSR into padded buffers; returns
        (ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals, ovf_count) or
        None when the overflow capacity is insufficient."""
        r = rowptr.shape[0] - 1
        bufs = self._ell_buffers(rows_alloc if rows_alloc else r, k, trash_col,
                                 max(ovf_cap, 1), ovf_row_fill)
        ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals = bufs
        n = self._dll.csr_to_ell(
            rowptr, np.ascontiguousarray(col, dtype=np.int32),
            self._fptr(value), r, k, ell_cols.reshape(-1), ell_vals.reshape(-1),
            ovf_rows, ovf_cols, ovf_vals, ovf_cap,
        )
        if n < 0:
            return None
        return ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals, int(n)

    def csr_to_ell_t(self, rowptr, col, value, num_cols, k, trash_col,
                     ovf_cap, rows_alloc=None, ovf_row_fill=0,
                     k_fwd=0, fwd_ovf_base=0, with_perm=False):
        """Hybrid ELL of the input's TRANSPOSE in one C++ pass; same output
        contract as :meth:`csr_to_ell`, with result rows = input columns.
        With ``with_perm`` it also returns ``t2f``: for every transpose slot
        (the flattened ``[num_cols, k]`` ELL, then the overflow), the flat
        position of the same edge in the forward layout (an ELL of width
        ``k_fwd`` whose overflow starts at flat index ``fwd_ovf_base``); -1
        on padding.  Without it ``t2f`` is None."""
        r = rowptr.shape[0] - 1
        rows_alloc = rows_alloc if rows_alloc else num_cols
        assert not with_perm or rows_alloc == num_cols, "t2f covers num_cols rows"
        bufs = self._ell_buffers(rows_alloc, k, trash_col, max(ovf_cap, 1),
                                 ovf_row_fill)
        ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals = bufs
        t2f = t2f_ptr = None
        if with_perm:
            t2f = np.full(num_cols * k + max(ovf_cap, 1), -1, dtype=np.int64)
            t2f_ptr = t2f.ctypes.data_as(ctypes.c_void_p)
        n = self._dll.csr_to_ell_t(
            rowptr, np.ascontiguousarray(col, dtype=np.int32),
            self._fptr(value), r, num_cols, k,
            ell_cols.reshape(-1), ell_vals.reshape(-1),
            ovf_rows, ovf_cols, ovf_vals, ovf_cap, k_fwd, fwd_ovf_base, t2f_ptr,
        )
        if n < 0:
            return None
        return ell_cols, ell_vals, ovf_rows, ovf_cols, ovf_vals, int(n), t2f

    def blocks_count(self, rowptr, col, ncb, thresh, rb_rows=128):
        """Dense-tile pre-pass: (total, per-row-block dense-tile counts,
        per-row remainder degrees)."""
        r = rowptr.shape[0] - 1
        nrb = (r + rb_rows - 1) // rb_rows
        nd = np.zeros(max(nrb, 1), dtype=np.int64)
        rem = np.zeros(max(r, 1), dtype=np.int64)
        total = self._dll.blocks_count(
            rowptr, np.ascontiguousarray(col, dtype=np.int32), r, ncb, thresh,
            rb_rows, nd, rem)
        return int(total), nd[:nrb], rem[:r]

    def tile_csr_fill(self, rowptr, col, value, ncb, thresh, tile_start,
                      rem_rowptr, ent_rowptr, bcol, rem_col, rem_val, ent_col,
                      ent_val, rb_rows=128):
        """The dense tier's column blocks, remainder and tile-CSR entries
        (f32, or bf16 bits in a 2-byte ``ent_val``) in place; returns
        ``(entry count, [r+1] entry row pointers)``."""
        r = rowptr.shape[0] - 1
        out_rowptr = np.empty(r + 1, dtype=np.int64)
        n = self._tile_dll.tile_csr_fill(
            rowptr, np.ascontiguousarray(col, dtype=np.int32),
            self._fptr(value), r, ncb, thresh, rb_rows,
            np.ascontiguousarray(tile_start, dtype=np.int64),
            np.ascontiguousarray(rem_rowptr, dtype=np.int64),
            np.ascontiguousarray(ent_rowptr, dtype=np.int64),
            1 if ent_val.dtype.itemsize == 2 else 0, bcol, rem_col, rem_val,
            ent_col, ent_val.ctypes.data_as(ctypes.c_void_p), out_rowptr)
        return int(n), out_rowptr

    def transpose_csr(self, rowptr, col, value, num_cols):
        r = rowptr.shape[0] - 1
        nnz = int(rowptr[-1])
        t_rowptr = np.empty(num_cols + 1, dtype=np.int64)
        t_col = np.empty(nnz, dtype=np.int32)
        t_val = np.empty(nnz, dtype=np.float32) if value is not None else None
        self._dll.transpose_csr(
            rowptr, np.ascontiguousarray(col, dtype=np.int32),
            self._fptr(value), r, num_cols, t_rowptr, t_col, self._fptr(t_val),
        )
        return t_rowptr, t_col, t_val


def native_lib() -> NativeGraphLib:
    """Load the native graph library, building it on first use; raises if
    it cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            _build(_SRC, _SO)
            _build(_TILE_SRC, _TILE_SO)
            _LIB = NativeGraphLib(ctypes.CDLL(_SO), ctypes.CDLL(_TILE_SO))
    return _LIB
