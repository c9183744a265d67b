"""Bindings of the hand-written Hopper kernels, with their plain versions.

Two kernels carry every aggregation of the port's main path:

- **kernel A**, :func:`block_spmm` (``csrc/block_spmm.cu``): dense-tile
  aggregation, the counterpart of the Pallas kernel
  ``incagg_gnn_tpu/ops/block.py::_dense_call``;
- **kernel B**, :func:`ell_spmm` (``csrc/ell_spmm.cu``): ELL
  gather-multiply-reduce, the counterpart of the Pallas blueprint
  ``incagg_gnn_tpu/ops/pallas_spmm.py::pallas_spmm_ell_vmem``.

A third, **kernel C**, :func:`ell_reduce` (``csrc/ell_reduce.cu``), is the
counterpart of ``incagg_gnn_tpu/ops/pallas_spmm.py::pallas_ell_reduce``: the
weighted K-reduction of rows already gathered.  No path calls it (kernel B
fuses the gather); it is held against its plain version like the others.

All are compiled by ``nvcc`` for ``sm_90a`` into one plain-C shared library
under the git-ignored ``build/`` directory on first use, loaded with
``ctypes``, and launched on PyTorch's current stream.  They allocate
nothing: the wrappers allocate the outputs.  Each wrapper takes its plain
PyTorch version for a tensor on the CPU only; for a CUDA tensor it launches
the kernel or raises.  ``<wrapper>.launches`` counts the launches.
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

_B = 128  # tile width of the dense tier (ops.block.B)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> float:
    """Compile the kernel library from the sources under ``csrc/`` if it is
    missing or older than a source; returns the seconds spent.  The
    compiler's register and shared-memory report goes to
    ``build/kernels_build.log``."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if os.path.exists(_SO) and all(
            os.path.getmtime(_SO) >= os.path.getmtime(s) for s in srcs):
        return 0.0
    t = time.perf_counter()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(_LOG, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (see {_LOG}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, _SO)
    return time.perf_counter() - t


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
                    # a, brow_step, bcols, x, out, S, lanes, rb, D, nrb, stream
                    fn.argtypes = [p, p, p, p, p, i64, i, i, i, i64, p]
                    fn.restype = i
                # cols, vals, x, out, R, K, D, stream
                lib.ell_spmm_f32.argtypes = [p, p, p, p, i64, i, i, p]
                lib.ell_spmm_f32.restype = i
                # g, vals, out, R, K, D, stream
                lib.ell_reduce_f32.argtypes = [p, p, p, i64, i, i, p]
                lib.ell_reduce_f32.restype = i
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
# kernel A: dense-tile aggregation
# ---------------------------------------------------------------------------

def block_spmm_reference(dense, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of kernel A (the JAX package's ``_dense_reference``):
    gather each tile's 128-row x block, batched f32 matmul, sum by
    row-block.  ``dense`` has fields ``a [NB, rb, 128]``, ``brow_step [S]``
    and ``bcols [lanes, S]`` (``BlockDense`` or ``OvfIncidence``)."""
    lanes = int(dense.bcols.shape[0])
    rb = int(dense.a.shape[1])
    d = x.shape[1]
    bcol_flat = dense.bcols.t().reshape(-1).long()  # [NB] tile -> col block
    brow_flat = dense.brow_step.long().repeat_interleave(lanes)  # tile -> row block
    g = x.reshape(-1, _B, d).index_select(0, bcol_flat)  # [NB, 128, d]
    prod = torch.bmm(dense.a.float(), g.float())  # [NB, rb, d]
    nrb = -(-num_rows // rb)
    out = torch.zeros(nrb, rb, d, dtype=torch.float32, device=x.device)
    out = out.index_add(0, brow_flat, prod)
    return out.reshape(nrb * rb, d)[:num_rows]


def block_spmm(dense, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Kernel A: ``out[r] = Σ_tiles A_tile[r] @ x[128-row block of the
    tile]`` in f32, for ``x`` of the tile dtype (f32 or bf16); returns
    ``[num_rows, D]`` f32."""
    if x.device.type == "cpu":
        return block_spmm_reference(dense, x, num_rows)
    a, brow_step, bcols = dense.a, dense.brow_step, dense.bcols
    _check_cuda_inputs("block_spmm", x, a, brow_step, bcols)
    lanes, s = int(bcols.shape[0]), int(bcols.shape[1])
    rb, d = int(a.shape[1]), int(x.shape[1])
    if a.dtype not in (torch.float32, torch.bfloat16) or x.dtype != a.dtype:
        raise TypeError(f"block_spmm: tiles {a.dtype} and x {x.dtype}; "
                        f"needs both float32 or both bfloat16")
    if brow_step.dtype != torch.int32 or bcols.dtype != torch.int32:
        raise TypeError("block_spmm: brow_step and bcols must be int32")
    if (a.dim() != 3 or a.shape[0] != s * lanes or a.shape[2] != _B
            or rb % _B or brow_step.shape != (s,)):
        raise ValueError(f"block_spmm: bad tile layout a={tuple(a.shape)} "
                         f"brow_step={tuple(brow_step.shape)} "
                         f"bcols={tuple(bcols.shape)}")
    if x.dim() != 2 or x.shape[0] % _B:
        raise ValueError(f"block_spmm: x rows {tuple(x.shape)} not a "
                         f"multiple of {_B}")
    if a.data_ptr() % 16:
        raise ValueError("block_spmm: tiles must start 16-byte aligned")
    nrb = -(-num_rows // rb)
    out = torch.empty((nrb * rb, d), dtype=torch.float32, device=x.device)
    fn = _lib().block_spmm_bf16 if a.dtype == torch.bfloat16 else _lib().block_spmm_f32
    rc = fn(a.data_ptr(), brow_step.data_ptr(), bcols.data_ptr(), x.data_ptr(),
            out.data_ptr(), s, lanes, rb, d, nrb,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("block_spmm", rc)
    block_spmm.launches += 1
    return out[:num_rows]


block_spmm.launches = 0


# ---------------------------------------------------------------------------
# kernel B: ELL gather-multiply-reduce
# ---------------------------------------------------------------------------

def ell_spmm_reference(cols: torch.Tensor, vals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: ``(x[cols] * vals[..., None]).sum(1)``."""
    r, k = cols.shape
    g = x.index_select(0, cols.reshape(-1)).reshape(r, k, x.shape[1])
    return (g * vals[..., None]).sum(dim=1)


def ell_spmm(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Kernel B: ``out[r] = Σ_k vals[r,k] · x[cols[r,k]]`` over an ELL table
    ``[R, K]``, gather fused into the reduce; float32 only."""
    if x.device.type == "cpu":
        return ell_spmm_reference(cols, vals, x)
    _check_cuda_inputs("ell_spmm", x, cols, vals)
    if x.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"ell_spmm: float32 only, got x {x.dtype} vals {vals.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError("ell_spmm: cols must be int32")
    if cols.dim() != 2 or cols.shape != vals.shape or x.dim() != 2:
        raise ValueError(f"ell_spmm: cols {tuple(cols.shape)} vals "
                         f"{tuple(vals.shape)} x {tuple(x.shape)}")
    r, k = int(cols.shape[0]), int(cols.shape[1])
    d = int(x.shape[1])
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    rc = _lib().ell_spmm_f32(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                             out.data_ptr(), r, k, d,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch("ell_spmm", rc)
    ell_spmm.launches += 1
    return out


ell_spmm.launches = 0


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
