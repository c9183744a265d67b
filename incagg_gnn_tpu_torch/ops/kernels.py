"""Bindings of the hand-written Hopper kernels, with their plain versions.

Two kernels carry every aggregation of the port's main path:

- **kernel A**, :func:`block_spmm` (``csrc/block_spmm.cu``): the dense
  tier's aggregation over the tiles' nonzeros (tile-CSR), the counterpart
  of the Pallas kernel ``incagg_gnn_tpu/ops/block.py::_dense_call``;
- **kernel B**, :func:`hybrid_spmm` and :func:`ell_spmm`
  (``csrc/ell_spmm.cu``): ELL gather-multiply-reduce over the real slots,
  the counterpart of the Pallas blueprint
  ``incagg_gnn_tpu/ops/pallas_spmm.py::pallas_spmm_ell_vmem``;
  :func:`hybrid_spmm` sums each row's COO overflow tail in the same launch
  (the JAX package's XLA ``segment_sum``), :func:`ell_spmm` is the ELL
  core alone, and :func:`hybrid_spmm_heads` is the fused call with one
  value per slot and head (GAT's attention-weighted message sum);
- **kernel B's storage-dtype form**, :func:`hybrid_spmm_table`
  (``csrc/ell_spmm.cu``, the same kernels templated on the row type): the
  fused call over global columns, x a history cache table in its storage
  dtype (f32, bf16 or float8), each row converted in registers and summed
  in f32 (the refresh sweep of global-column eval batches); its f32
  instance is kernel B's fused f32 kernel itself;
- **kernel B's max form**, :func:`hybrid_max` and :func:`hybrid_max_bwd`
  (``csrc/ell_max.cu``): the row-max over the real slots and the tail, with
  the tie counts, and its backward over the transpose (PNA's max and min
  aggregators); the JAX package computes these in XLA
  (``incagg_gnn_tpu/ops/ell.py::spmm_hybrid_max``, ``_spmm_max_bi_bw``),
  with no Pallas kernel;

A third, **kernel C**, :func:`ell_reduce` (``csrc/ell_reduce.cu``), is the
counterpart of ``incagg_gnn_tpu/ops/pallas_spmm.py::pallas_ell_reduce``: the
weighted K-reduction of rows already gathered.  No path calls it (kernel B
fuses the gather); it is held against its plain version like the others.

All are compiled by ``nvcc`` for ``sm_90a`` into one plain-C shared library
under the git-ignored ``build/`` directory on first use, loaded with
``ctypes``, and launched on PyTorch's current stream.  They allocate
nothing: the wrappers allocate the outputs.  Each wrapper takes its plain
PyTorch version for a tensor on the CPU only; for a CUDA tensor it launches
the kernel or raises.  ``<wrapper>.launches`` counts the launches
(``ell_spmm.launches`` every launch of kernel B, ``hybrid_spmm.launches``
the fused ones, ``hybrid_spmm_heads.launches`` those with more than one
head; ``hybrid_max.launches`` and ``hybrid_max_bwd.launches`` the max
form's; ``hybrid_spmm_table.launches`` the storage-dtype form's, which
counts in no other counter).  A CUDA graph replays launches without
calling the wrappers: :func:`launch_counts` and :func:`add_launches` let
its runner count them per replay.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "incagg_gnn_tpu_torch", "csrc")
_BUILD = os.path.join(_ROOT, "build")
_SO = os.path.join(_BUILD, "libincagg_kernels.so")
_LOG = os.path.join(_BUILD, "kernels_build.log")

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> float:
    """Compile the kernel library from the sources under ``csrc/`` if it is
    missing or older than a source; returns the seconds spent.  Each source
    compiles in its own ``nvcc``, all started together, then one link.  The
    compiler's register and shared-memory report goes to
    ``build/kernels_build.log``."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if os.path.exists(_SO) and all(
            os.path.getmtime(_SO) >= os.path.getmtime(s) for s in srcs):
        return 0.0
    t = time.perf_counter()
    os.makedirs(_BUILD, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [os.path.join(_BUILD, f"{os.path.basename(src)}.{tag}.o") for src in srcs]
    cmds = [[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c", src, "-o", obj]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate(timeout=600) for p in procs]
    tmp = f"{_SO}.{tag}"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    report = "".join(" ".join(c) + "\n" + o + e for c, (o, e) in zip(cmds, outs))
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True, timeout=600)
        report += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = [link]
    with open(_LOG, "w") as f:
        f.write(report)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed (see {_LOG}):\n{report[-4000:]}")
    os.replace(tmp, _SO)
    return time.perf_counter() - t


def bind_max_form(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ell_max.cu``'s two entry points
    on ``lib`` (this library, or another build of a file with the same
    interface)."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # cols, vals, ovf_ptr, ovf_cols, ovf_vals, deg, x, out, ties, R, K, D, stream
    lib.hybrid_max_f32.argtypes = [p, p, p, p, p, p, p, p, p, i64, i, i, p]
    lib.hybrid_max_f32.restype = i
    # the transpose's tables, g, ties, out, deg_fwd, x, h, dx, C, K, D, R_fwd, stream
    lib.hybrid_max_bwd_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i64, i, i, i64, p]
    lib.hybrid_max_bwd_f32.restype = i
    return lib


def bind_spmm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ell_spmm.cu``'s three entry points
    on ``lib`` (this library, or another build of a file with the same
    interface)."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, stream
    lib.ell_spmm_f32.argtypes = [p, p, p, p, p, p, p, i64, i, i, p]
    lib.ell_spmm_f32.restype = i
    # the same, then R, K, H, Dh, stream
    lib.ell_spmm_heads_f32.argtypes = [p, p, p, p, p, p, p, i64, i, i, i, p]
    lib.ell_spmm_heads_f32.restype = i
    # row type, cols, vals, ovf_ptr, ovf_cols, ovf_vals, x, out, R, K, D, stream
    lib.ell_spmm_table.argtypes = [i, p, p, p, p, p, p, p, i64, i, i, p]
    lib.ell_spmm_table.restype = i
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                build_kernels()
                lib = ctypes.CDLL(_SO)
                p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                for name in ("block_spmm_f32", "block_spmm_bf16"):
                    fn = getattr(lib, name)
                    # rowptr, cols, vals, x, out, R, D, stream
                    fn.argtypes = [p, p, p, p, p, i64, i, p]
                    fn.restype = i
                bind_spmm(lib)
                # the heads form with its values read per slot (tests)
                lib.ell_spmm_heads_f32_per_slot.argtypes = lib.ell_spmm_heads_f32.argtypes
                lib.ell_spmm_heads_f32_per_slot.restype = i
                # g, vals, out, R, K, D, stream
                lib.ell_reduce_f32.argtypes = [p, p, p, i64, i, i, p]
                lib.ell_reduce_f32.restype = i
                bind_max_form(lib)
                lib.hybrid_max_chunk_cols.argtypes = [i]
                lib.hybrid_max_chunk_cols.restype = i
                _LIB = lib
    return _LIB


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _check_cuda_inputs(name: str, x: torch.Tensor, *tensors) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    for t in (x, *tensors):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if torch.is_grad_enabled() and x.requires_grad:
        # the kernels have no backward of their own: training differentiates
        # through the Bi pairs, whose backward is the forward over A^T
        raise RuntimeError(
            f"{name}: forward-only on CUDA; train through a Bi* adjacency")


# ---------------------------------------------------------------------------
# kernel A: tile aggregation over the tiles' nonzeros
# ---------------------------------------------------------------------------

def block_spmm_reference(dense, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of kernel A: ``out[r] = Σ_e vals[e] · x[cols[e]]`` over
    row ``r``'s tile-CSR entries (``rowptr``/``cols``/``vals`` of a
    ``BlockDense`` or ``OvfIncidence``), summed by ``index_add`` and
    returned in f32 (entries past ``rowptr[-1]`` are padding); the same
    function as the JAX package's ``_dense_reference`` over the dense tiles.  The products and sums are
    taken in f64 (a product of two f32 values is exact there), so the
    result does not hang on the order of a long row's entries, which
    differs from the order of the tile product's blocked f32 sum."""
    rowptr = dense.rowptr.long()
    n_out = rowptr.numel() - 1
    n = int(rowptr[-1])  # past it: padding entries
    rows = torch.repeat_interleave(torch.arange(n_out, device=x.device),
                                   rowptr.diff(), output_size=n)
    prod = (dense.vals[:n].double()[:, None]
            * x.index_select(0, dense.cols[:n].long()).double())
    out = torch.zeros(n_out, x.shape[1], dtype=torch.float64, device=x.device)
    return out.index_add_(0, rows, prod)[:num_rows].float()


def block_spmm(dense, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Kernel A: ``out[r] = Σ_e vals[e] · x[cols[e]]`` over the entries of
    row ``r`` (the tiles' nonzeros: ``Σ_tiles A_tile[r] @ x[128-row block of
    the tile]``) in f32, for ``x`` of the tile dtype (f32 or bf16); returns
    ``[num_rows, D]`` f32.  ``cols`` must index rows of ``x``."""
    if x.device.type == "cpu":
        return block_spmm_reference(dense, x, num_rows)
    rowptr, cols, vals = dense.rowptr, dense.cols, dense.vals
    _check_cuda_inputs("block_spmm", x, rowptr, cols, vals)
    if vals.dtype not in (torch.float32, torch.bfloat16) or x.dtype != vals.dtype:
        raise TypeError(f"block_spmm: tiles {vals.dtype} and x {x.dtype}; "
                        f"needs both float32 or both bfloat16")
    if rowptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("block_spmm: rowptr and cols must be int32")
    if (rowptr.dim() != 1 or cols.dim() != 1 or cols.shape != vals.shape
            or rowptr.numel() - 1 < num_rows or x.dim() != 2):
        raise ValueError(f"block_spmm: bad tile-CSR rowptr={tuple(rowptr.shape)} "
                         f"cols={tuple(cols.shape)} vals={tuple(vals.shape)} "
                         f"x={tuple(x.shape)} for {num_rows} rows")
    d = int(x.shape[1])
    out = torch.empty((num_rows, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _lib().block_spmm_bf16 if vals.dtype == torch.bfloat16 else _lib().block_spmm_f32
    rc = fn(rowptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
            out.data_ptr(), num_rows, d,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("block_spmm", rc)
    block_spmm.launches += 1
    return out


block_spmm.launches = 0


# ---------------------------------------------------------------------------
# kernel B: ELL gather-multiply-reduce, with the overflow tail fused
# ---------------------------------------------------------------------------

def rows_f32(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``x`` upcast to f32 (float8 rows gathered as their
    bytes: ``index_select`` has no float8 kernel on every device)."""
    if x.element_size() == 1:
        return x.view(torch.uint8).index_select(0, idx).view(x.dtype).float()
    return x.index_select(0, idx).float()


def ell_spmm_reference(cols: torch.Tensor, vals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B's ELL core: ``(x[cols] * vals[..., None]).sum(1)``,
    x rows upcast to f32 after the gather."""
    r, k = cols.shape
    g = rows_f32(x, cols.reshape(-1)).reshape(r, k, x.shape[1])
    return (g * vals[..., None]).sum(dim=1)


def hybrid_spmm_reference(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                          ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                          ovf_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel B and of its storage-dtype form:
    the plain ELL sum, then the overflow entries that ``ovf_ptr`` covers
    gathered, upcast, weighted and added to their rows (``index_select``,
    ``*``, ``index_add``)."""
    out = ell_spmm_reference(ell_cols, ell_vals, x)
    n = int(ovf_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(out.shape[0], device=x.device),
                                   ovf_ptr.diff().long(), output_size=n)
    go = rows_f32(x, ovf_cols[:n]) * ovf_vals[:n, None]
    return out.index_add(0, rows, go.to(out.dtype))


def _check_b_operands(name: str, cols, vals, tail, x: torch.Tensor, slots,
                      any_row_type: bool = False) -> None:
    """Kernel B's operand checks; ``slots`` is the ``[R, K]`` shape that
    ``vals`` holds a value (or, in the heads form, a row of values) for,
    ``tail`` is ``(ovf_ptr, ovf_cols, ovf_vals)`` or None; ``any_row_type``:
    x may be of any type the caller checked (the storage-dtype form)."""
    extra = tail if tail is not None else ()
    _check_cuda_inputs(name, x, cols, vals, *extra)
    if (x.dtype != torch.float32 and not any_row_type) or vals.dtype != torch.float32:
        raise TypeError(f"{name}: float32 only, got x {x.dtype} vals {vals.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"{name}: cols must be int32")
    if cols.dim() != 2 or cols.shape != slots or x.dim() != 2:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} vals "
                         f"{tuple(vals.shape)} x {tuple(x.shape)}")
    if tail is not None:
        ovf_ptr, ovf_cols, ovf_vals = tail
        if ovf_ptr.dtype != torch.int32 or ovf_cols.dtype != torch.int32:
            raise TypeError(f"{name}: ovf_ptr and ovf_cols must be int32")
        if ovf_vals.dtype != torch.float32:
            raise TypeError(f"{name}: ovf_vals must be float32, got {ovf_vals.dtype}")
        if (ovf_ptr.dim() != 1 or ovf_ptr.numel() != cols.shape[0] + 1
                or ovf_cols.dim() != 1 or ovf_cols.shape[0] != ovf_vals.shape[0]):
            raise ValueError(f"{name}: ovf_ptr {tuple(ovf_ptr.shape)} ovf_cols "
                             f"{tuple(ovf_cols.shape)} ovf_vals "
                             f"{tuple(ovf_vals.shape)} for {cols.shape[0]} rows")


def _launch_b(name: str, cols, vals, tail, x: torch.Tensor) -> torch.Tensor:
    """Check kernel B's operands and launch it; ``tail`` is ``(ovf_ptr,
    ovf_cols, ovf_vals)`` for the fused call, None for the ELL core."""
    _check_b_operands(name, cols, vals, tail, x, vals.shape)
    if tail is not None and tail[2].dim() != 1:
        raise ValueError(f"{name}: ovf_vals {tuple(tail[2].shape)} is not [O]")
    r, k = int(cols.shape[0]), int(cols.shape[1])
    ptrs = (0, 0, 0) if tail is None else tuple(t.data_ptr() for t in tail)
    d = int(x.shape[1])
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib().ell_spmm_f32(cols.data_ptr(), vals.data_ptr(), *ptrs, x.data_ptr(),
                             out.data_ptr(), r, k, d,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    ell_spmm.launches += 1
    return out


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Kernel B on an ELL table ``[R, K]`` alone: ``out[r] = Σ_k vals[r,k] ·
    x[cols[r,k]]``, gather fused into the reduce; float32 only."""
    if x.device.type == "cpu":
        return ell_spmm_reference(cols, vals, x)
    return _launch_b("ell_spmm", cols, vals, None, x)


ell_spmm.launches = 0  # every launch of kernel B, fused or not


def hybrid_spmm(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                ovf_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Kernel B with the overflow tail in the same launch: each row's ELL
    sum plus the sum over its overflow entries ``ovf_ptr[r] ..
    ovf_ptr[r+1]`` (written as ``ell_sum + tail_sum``); float32 only."""
    if x.device.type == "cpu":
        return hybrid_spmm_reference(ell_cols, ell_vals, ovf_ptr, ovf_cols,
                                     ovf_vals, x)
    out = _launch_b("hybrid_spmm", ell_cols, ell_vals,
                    (ovf_ptr, ovf_cols, ovf_vals), x)
    hybrid_spmm.launches += 1
    return out


hybrid_spmm.launches = 0  # the fused launches alone

#: the storage-dtype form's row types, as ``csrc/ell_spmm.cu`` numbers them
TABLE_ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
                   torch.float8_e5m2: 3}


def hybrid_spmm_table(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                      ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                      ovf_vals: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel B's storage-dtype form: the fused call (each row's ELL sum
    plus its overflow tail ``ovf_ptr[r] .. ovf_ptr[r+1]``) over a table
    ``[C, D]`` of f32, bf16, float8_e4m3fn or float8_e5m2 rows, which the
    kernel converts in registers; values f32, sums and ``out [R, D]`` f32.
    The columns index rows of ``table`` (global columns: a history cache)."""
    if table.device.type == "cpu":
        return hybrid_spmm_reference(ell_cols, ell_vals, ovf_ptr, ovf_cols,
                                     ovf_vals, table)
    name = "hybrid_spmm_table"
    if table.dtype not in TABLE_ROW_TYPES:
        raise TypeError(f"{name}: no row type {table.dtype}; one of "
                        f"{sorted(map(str, TABLE_ROW_TYPES))}")
    _check_b_operands(name, ell_cols, ell_vals, (ovf_ptr, ovf_cols, ovf_vals),
                      table, ell_vals.shape, any_row_type=True)
    r, k, d = int(ell_cols.shape[0]), int(ell_cols.shape[1]), int(table.shape[1])
    out = torch.empty((r, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    rc = _lib().ell_spmm_table(
        TABLE_ROW_TYPES[table.dtype], ell_cols.data_ptr(), ell_vals.data_ptr(),
        ovf_ptr.data_ptr(), ovf_cols.data_ptr(), ovf_vals.data_ptr(), table.data_ptr(),
        out.data_ptr(), r, k, d, torch.cuda.current_stream(table.device).cuda_stream)
    _check_launch(name, rc)
    hybrid_spmm_table.launches += 1
    return out


hybrid_spmm_table.launches = 0


def hybrid_spmm_heads_reference(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                                ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                                ovf_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the heads form: ``x [C, H*Dh]`` seen as ``[C, H,
    Dh]``, each head weighted by its own values ``ell_vals [R, K, H]`` and
    ``ovf_vals [O, H]``; the ELL sum, then the covered overflow entries
    added to their rows (``index_add``)."""
    r, k, h = ell_vals.shape
    d = x.shape[1] // h
    g = x.index_select(0, ell_cols.reshape(-1)).reshape(r, k, h, d)
    out = (g * ell_vals[..., None]).sum(dim=1)
    n = int(ovf_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(r, device=x.device),
                                   ovf_ptr.diff().long(), output_size=n)
    go = x.index_select(0, ovf_cols[:n]).reshape(n, h, d) * ovf_vals[:n, :, None]
    return out.index_add(0, rows, go.to(out.dtype)).reshape(r, h * d)


def hybrid_spmm_heads(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                      ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                      ovf_vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Kernel B, fused with the overflow tail, with a value per slot and
    head: ``out[r, h*Dh:(h+1)*Dh] = Σ_k ell_vals[r,k,h] · x[ell_cols[r,k],
    h*Dh:(h+1)*Dh]`` plus the tail the same way, for ``x [C, H*Dh]``,
    ``ell_vals [R, K, H]`` and ``ovf_vals [O, H]``; float32 only.  One
    head is the plain fused call on the tables without their head axis."""
    if x.device.type == "cpu":
        return hybrid_spmm_heads_reference(ell_cols, ell_vals, ovf_ptr, ovf_cols,
                                           ovf_vals, x)
    name = "hybrid_spmm_heads"
    if ell_vals.dim() != 3 or ovf_vals.dim() != 2 or ovf_vals.shape[1] != ell_vals.shape[2]:
        raise ValueError(f"{name}: ell_vals {tuple(ell_vals.shape)} ovf_vals "
                         f"{tuple(ovf_vals.shape)}; needs [R, K, H] and [O, H]")
    h = int(ell_vals.shape[2])
    if x.dim() != 2 or x.shape[1] % h:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [C, {h} * Dh]")
    if h == 1:
        return hybrid_spmm(ell_cols, ell_vals[..., 0], ovf_ptr, ovf_cols,
                           ovf_vals[:, 0], x)
    _check_b_operands(name, ell_cols, ell_vals, (ovf_ptr, ovf_cols, ovf_vals), x,
                      ell_vals.shape[:2])
    r, k = int(ell_cols.shape[0]), int(ell_cols.shape[1])
    out = torch.empty((r, int(x.shape[1])), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib().ell_spmm_heads_f32(
        ell_cols.data_ptr(), ell_vals.data_ptr(), ovf_ptr.data_ptr(),
        ovf_cols.data_ptr(), ovf_vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        r, k, h, int(x.shape[1]) // h, torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    ell_spmm.launches += 1
    hybrid_spmm.launches += 1
    hybrid_spmm_heads.launches += 1
    return out


hybrid_spmm_heads.launches = 0  # the launches of the heads form with H > 1


# ---------------------------------------------------------------------------
# kernel B's max form: row-max with tie counts, and its backward
# ---------------------------------------------------------------------------

#: bytes one plain-version gather ``[rows, K, D]`` may materialize before it
#: is taken in row chunks (the JAX package row-chunks the same gathers)
_GATHER_BUDGET_BYTES = 512 << 20


def _row_chunks(r: int, bytes_per_row: int):
    """``(start, stop)`` row ranges whose gathers stay under the budget."""
    step = max(1, _GATHER_BUDGET_BYTES // max(bytes_per_row, 1))
    return [(a, min(a + step, r)) for a in range(0, r, step)]


def _tail_rows(ovf_ptr: torch.Tensor, r: int):
    """The number of real overflow entries and the row of each."""
    n = int(ovf_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(r, device=ovf_ptr.device),
                                   ovf_ptr.diff().long(), output_size=n)
    return n, rows


def hybrid_max_reference(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                         ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                         ovf_vals: torch.Tensor, deg: torch.Tensor, x: torch.Tensor,
                         want_ties: bool = False):
    """Plain version of the max form, step by step as the JAX package's
    ``_ell_max`` and ``spmm_hybrid_max`` (``ops/ell.py:940-967``): the ELL
    slots gathered in row chunks, padding masked to the dtype's lowest
    value, the row max; the overflow entries that ``ovf_ptr`` covers
    reduced into it (``scatter_reduce`` amax); rows of degree 0 zeroed.
    With ``want_ties``, ``_max_tie_count`` (:970): per row and column the
    count of real slots equal to ``out``, at least 1.  Returns ``(out,
    ties or None)``."""
    r, k = ell_cols.shape
    d = x.shape[1]
    neg = torch.finfo(x.dtype).min
    cols = ell_cols.long()
    chunks = _row_chunks(r, k * d * x.element_size()) if k else []
    out = x.new_full((r, d), neg)
    for a, b in chunks:
        g = x.index_select(0, cols[a:b].reshape(-1)).reshape(b - a, k, d)
        out[a:b] = torch.where((ell_vals[a:b] != 0)[..., None], g, neg).amax(dim=1)
    n, rows = _tail_rows(ovf_ptr, r)
    oc = ovf_cols[:n].long()
    go = torch.where((ovf_vals[:n] != 0)[:, None], x.index_select(0, oc), neg)
    out = out.scatter_reduce(0, rows[:, None].expand(-1, d), go, "amax", include_self=True)
    out = torch.where(deg[:, None] > 0, out, 0.0)
    if not want_ties:
        return out, None
    cnt = x.new_zeros((r, d))
    for a, b in chunks:
        g = x.index_select(0, cols[a:b].reshape(-1)).reshape(b - a, k, d)
        eq = (ell_vals[a:b] != 0)[..., None] & (g == out[a:b, None, :])
        cnt[a:b] = eq.sum(dim=1).to(x.dtype)
    eq = (ovf_vals[:n] != 0)[:, None] & (x.index_select(0, oc) == out.index_select(0, rows))
    cnt = cnt.index_add(0, rows, eq.to(x.dtype))
    return out, cnt.clamp(min=1.0)


def hybrid_max_bwd_reference(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
                             ovf_ptr: torch.Tensor, ovf_cols: torch.Tensor,
                             ovf_vals: torch.Tensor, g: torch.Tensor, ties: torch.Tensor,
                             out: torch.Tensor, x: torch.Tensor,
                             fwd_deg: torch.Tensor) -> torch.Tensor:
    """Plain version of the max form's backward, step by step as the JAX
    package's ``_spmm_max_bi_bw`` (``ops/ell.py:1007-1044``): ``h = g /
    ties`` with ``g`` zeroed on forward rows of degree 0; over the
    transpose tables (rows = x rows, slots naming forward rows), ``dx[c] =
    Σ (out[r] == x[c]) ? h[r] : 0`` over the real ELL slots (gathered in
    row chunks), plus the same over the overflow entries ``ovf_ptr``
    covers (``index_add``)."""
    c, kt = ell_cols.shape
    d = x.shape[1]
    h = torch.where(fwd_deg[:, None] > 0, g, 0.0) / ties
    dx = x.new_zeros((c, d))
    for a, b in (_row_chunks(c, 2 * kt * d * x.element_size()) if kt else []):
        cols = ell_cols[a:b].long().reshape(-1)
        hg = h.index_select(0, cols).reshape(b - a, kt, d)
        og = out.index_select(0, cols).reshape(b - a, kt, d)
        eq = (ell_vals[a:b] != 0)[..., None] & (og == x[a:b, None, :])
        dx[a:b] = torch.where(eq, hg, 0.0).sum(dim=1)
    n, rows = _tail_rows(ovf_ptr, c)
    oc = ovf_cols[:n].long()
    eq = (ovf_vals[:n] != 0)[:, None] & (out.index_select(0, oc) == x.index_select(0, rows))
    return dx.index_add(0, rows, torch.where(eq, h.index_select(0, oc), 0.0))


def _check_rows(name: str, like: torch.Tensor, rows: int, d: int, **tensors) -> None:
    """``[rows, d]`` float32 operands (``[rows]`` where ``d`` is None) on
    ``like``'s device, contiguous."""
    for key, t in tensors.items():
        shape = (rows,) if d is None else (rows, d)
        if t.device != like.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {like.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)}, needs {shape}")


def hybrid_max(ell_cols: torch.Tensor, ell_vals: torch.Tensor, ovf_ptr: torch.Tensor,
               ovf_cols: torch.Tensor, ovf_vals: torch.Tensor, deg: torch.Tensor,
               x: torch.Tensor, want_ties: bool = False):
    """Kernel B's max form: per row and column the max of ``x`` over the
    row's real ELL slots and its overflow entries ``ovf_ptr[r] ..
    ovf_ptr[r+1]``, 0 on rows of degree 0; with ``want_ties`` also the
    count of real slots equal to it (at least 1; 1 on rows of degree 0).
    Float32 only; returns ``(out [R, D], ties [R, D] or None)``."""
    if x.device.type == "cpu":
        return hybrid_max_reference(ell_cols, ell_vals, ovf_ptr, ovf_cols, ovf_vals,
                                    deg, x, want_ties)
    name = "hybrid_max"
    _check_b_operands(name, ell_cols, ell_vals, (ovf_ptr, ovf_cols, ovf_vals), x,
                      ell_vals.shape)
    r, k, d = int(ell_cols.shape[0]), int(ell_cols.shape[1]), int(x.shape[1])
    _check_rows(name, x, r, None, deg=deg)
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    ties = torch.empty_like(out) if want_ties else None
    if out.numel() == 0:
        return out, ties
    rc = _lib().hybrid_max_f32(
        ell_cols.data_ptr(), ell_vals.data_ptr(), ovf_ptr.data_ptr(), ovf_cols.data_ptr(),
        ovf_vals.data_ptr(), deg.data_ptr(), x.data_ptr(), out.data_ptr(),
        ties.data_ptr() if want_ties else None, r, k, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    hybrid_max.launches += 1
    return out, ties


hybrid_max.launches = 0


def hybrid_max_bwd(ell_cols: torch.Tensor, ell_vals: torch.Tensor, ovf_ptr: torch.Tensor,
                   ovf_cols: torch.Tensor, ovf_vals: torch.Tensor, g: torch.Tensor,
                   ties: torch.Tensor, out: torch.Tensor, x: torch.Tensor,
                   fwd_deg: torch.Tensor) -> torch.Tensor:
    """The max form's backward over the transpose tables (rows = the rows
    of ``x``, slots naming forward rows): ``dx[c] = Σ (out[r] == x[c]) ?
    g[r] / ties[r] : 0`` over the real slots, ``g`` zeroed on forward rows
    of degree 0 (``fwd_deg``).  ``g``, ``ties``, ``out`` are ``[R, D]``,
    ``x`` is ``[C, D]``; float32 only; returns ``dx [C, D]``."""
    if x.device.type == "cpu":
        return hybrid_max_bwd_reference(ell_cols, ell_vals, ovf_ptr, ovf_cols, ovf_vals,
                                        g, ties, out, x, fwd_deg)
    name = "hybrid_max_bwd"
    _check_b_operands(name, ell_cols, ell_vals, (ovf_ptr, ovf_cols, ovf_vals), x,
                      ell_vals.shape)
    c, k, d = int(ell_cols.shape[0]), int(ell_cols.shape[1]), int(x.shape[1])
    if x.shape[0] != c:
        raise ValueError(f"{name}: x {tuple(x.shape)} for a transpose of {c} rows")
    r = int(out.shape[0])
    _check_rows(name, x, r, d, g=g, ties=ties, out=out)
    _check_rows(name, x, r, None, fwd_deg=fwd_deg)
    dx = torch.empty((c, d), dtype=torch.float32, device=x.device)
    if dx.numel() == 0 or r == 0:
        return dx.zero_()
    h = torch.empty_like(g)
    rc = _lib().hybrid_max_bwd_f32(
        ell_cols.data_ptr(), ell_vals.data_ptr(), ovf_ptr.data_ptr(), ovf_cols.data_ptr(),
        ovf_vals.data_ptr(), g.data_ptr(), ties.data_ptr(), out.data_ptr(),
        fwd_deg.data_ptr(), x.data_ptr(), h.data_ptr(), dx.data_ptr(), c, k, d, r,
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(name, rc)
    hybrid_max_bwd.launches += 1
    return dx


hybrid_max_bwd.launches = 0


def hybrid_max_chunk_cols() -> dict:
    """The column chunk of the max form's vector paths, as the built
    kernels launch it: a forward past ``hybrid_max`` columns walks chunks
    of that many (one lane group covers narrower rows whole), a backward
    past ``hybrid_max_bwd`` columns launches one ``max_bwd_step_kernel``
    a chunk.  Builds the library if need be."""
    lib = _lib()
    return {"hybrid_max": lib.hybrid_max_chunk_cols(0),
            "hybrid_max_bwd": lib.hybrid_max_chunk_cols(1)}


# ---------------------------------------------------------------------------
# kernel C: weighted K-reduction of gathered rows
# ---------------------------------------------------------------------------

def ell_reduce_reference(g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: ``(g * vals[..., None]).sum(1)``."""
    return (g * vals[..., None]).sum(dim=1)


def ell_reduce(g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Kernel C: ``out[r] = Σ_k vals[r,k] · g[r,k,:]`` for gathered rows
    ``g [R, K, D]`` and weights ``vals [R, K]``; float32 only, any R and D."""
    if g.device.type == "cpu":
        return ell_reduce_reference(g, vals)
    _check_cuda_inputs("ell_reduce", g, vals)
    if g.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"ell_reduce: float32 only, got g {g.dtype} vals {vals.dtype}")
    if g.dim() != 3 or vals.shape != g.shape[:2]:
        raise ValueError(f"ell_reduce: g {tuple(g.shape)} vals {tuple(vals.shape)}")
    r, k, d = (int(n) for n in g.shape)
    out = torch.empty((r, d), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    rc = _lib().ell_reduce_f32(g.data_ptr(), vals.data_ptr(), out.data_ptr(),
                               r, k, d, torch.cuda.current_stream(g.device).cuda_stream)
    _check_launch("ell_reduce", rc)
    ell_reduce.launches += 1
    return out


ell_reduce.launches = 0


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

#: the wrappers that count their launches
COUNTED = ("block_spmm", "ell_spmm", "hybrid_spmm", "hybrid_spmm_heads", "hybrid_max",
           "hybrid_max_bwd", "ell_reduce", "hybrid_spmm_table")


def launch_counts() -> dict:
    """Every wrapper's launch count, by name."""
    return {name: globals()[name].launches for name in COUNTED}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by wrapper name) to the launch counters: what one
    replay of a captured CUDA graph launches, since a replay calls no
    wrapper."""
    for name, n in counts.items():
        globals()[name].launches += n
