"""Ranks, devices and collectives of the multi-device path.

The counterpart of ``incagg_gnn_tpu/parallel/mesh.py`` (``make_mesh``,
``make_mesh_2d``, ``init_distributed``) over ``torch.distributed``.  A JAX
mesh is a set of devices one program drives under ``shard_map``; here
each device of the mesh is a rank, one process, and the collectives are
the lockstep.  A mesh is the world group in rank order
(:func:`init_distributed`).  A ``(hosts x chips)`` mesh (``n_hosts`` > 1)
is the same group, host-major (rank = ``host * chips + chip``, the order
JAX's tuple-axis collectives use); it changes only the layout the trainer
chooses (``parallel/layout.py``).

Each rank gets an explicit ``torch.device`` and an explicit backend
(:func:`place_ranks`): NCCL where every rank has a GPU of its own, gloo on
the CPU and where ranks share one card.  Two ranks on one device with NCCL
are refused; no backend is swapped for another after a failure.  Under gloo
a CUDA tensor is staged through host memory around each collective (gloo
moves host buffers); its seconds are the host wire's.

An all-to-all can stay in flight while the rank computes
(:func:`all_to_all_async`, a :class:`Pending` handle): the sharded
refresh collects its next round's halo that way.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh: ``rank`` of ``world`` ranks, its
    ``device`` and the group's ``backend``; ``n_hosts`` > 1 makes it a
    ``(hosts x chips)`` mesh.  ``calls`` and ``wire_bytes`` count this
    rank's collectives and the bytes it sent through them, ``wait_s`` the
    host seconds it spent blocked on all-to-all handles."""

    rank: int
    world: int
    device: torch.device
    backend: str
    n_hosts: int = 1
    calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        ("all_to_all", "all_reduce", "broadcast", "all_gather", "barrier"), 0))
    wire_bytes: int = 0
    wait_s: float = 0.0

    @property
    def staged(self) -> bool:
        """Whether collectives stage CUDA tensors through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def default_backend(device: str) -> str:
    """``nccl`` for CUDA devices, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def place_ranks(device: str, world: int, backend: str) -> List[torch.device]:
    """The device of each of ``world`` ranks: ``cpu`` puts every rank on
    the CPU (gloo only); ``cuda`` puts rank ``r`` on ``cuda:r`` and needs
    ``world`` visible GPUs; ``cuda:K`` puts every rank on that one card,
    which only gloo can share."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices; the CPU takes --dist-backend gloo")
        return [dev] * world
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if dev.index is None:
        have = torch.cuda.device_count()
        if have < world:
            raise RuntimeError(
                f"{world} ranks on --device cuda need {world} visible GPUs, found "
                f"{have}; to share one card pass --device cuda:0 --dist-backend gloo")
        return [torch.device("cuda", r) for r in range(world)]
    if backend == "nccl" and world > 1:
        raise ValueError(
            f"NCCL cannot put {world} ranks on the one device {dev}; share a card "
            f"with --device {dev} --dist-backend gloo, or give each rank its own "
            f"GPU with --device cuda")
    return [dev] * world


def init_distributed(rank: int, world: int, init_method: str, backend: str,
                     device, n_hosts: int = 1, timeout_s: float = 600.0) -> Mesh:
    """Join the process group (``init_method``: a ``file://`` or
    ``tcp://host:port`` rendezvous, or ``env://`` under ``torchrun``) and
    return this rank's :class:`Mesh`."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split into {n_hosts} hosts")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return Mesh(rank, world, device, backend, n_hosts)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Pending:
    """An all-to-all in flight (``work``: the ``dist`` handle, None when
    nothing travels).  :meth:`wait` blocks until it has landed and returns
    ``result()``; the handle keeps the send buffer alive until then."""

    def __init__(self, result: Callable[[], torch.Tensor], work=None,
                 mesh: Optional[Mesh] = None):
        self._result, self._work, self._mesh = result, work, mesh

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            t0 = time.perf_counter()
            self._work.wait()
            self._mesh.wait_s += time.perf_counter() - t0
            self._work = None
        return self._result()


def all_to_all_async(mesh: Mesh, send: torch.Tensor,
                     send_sizes: Optional[Sequence[int]] = None,
                     recv_sizes: Optional[Sequence[int]] = None) -> Pending:
    """``send``'s rows split to the ranks in order (equal chunks, or
    ``send_sizes`` rows each), the rows received from each rank
    concatenated in rank order (equal chunks, or ``recv_sizes`` each), as a
    :class:`Pending` whose ``wait()`` gives them on this rank's device.  A
    dtype other than float32 travels as its bytes.  Under gloo a CUDA send
    buffer is copied to host memory here (the host waits for the device),
    and the rows received go back to the device on the current stream at
    ``wait()``, ahead of whatever is queued after it; under NCCL ``wait()``
    orders the current stream after the collective's."""
    dtype = send.dtype
    wire = send if dtype == torch.float32 else send.contiguous().view(torch.uint8)
    rows_out = wire.shape[0] if recv_sizes is None else int(sum(recv_sizes))
    src = _host(mesh, wire.contiguous())
    out = torch.empty((rows_out,) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=src.device)
    work = dist.all_to_all_single(
        out, src, None if recv_sizes is None else [int(s) for s in recv_sizes],
        None if send_sizes is None else [int(s) for s in send_sizes], async_op=True)
    mesh.calls["all_to_all"] += 1
    mesh.wire_bytes += _nbytes(wire)

    def result(src=src) -> torch.Tensor:  # src: alive until the wait
        got = out.to(mesh.device, non_blocking=True) if mesh.staged else out
        return got if dtype == torch.float32 else got.view(dtype)

    return Pending(result, work, mesh)


def all_to_all(mesh: Mesh, send: torch.Tensor,
               send_sizes: Optional[Sequence[int]] = None,
               recv_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """:func:`all_to_all_async`, waited for."""
    return all_to_all_async(mesh, send, send_sizes, recv_sizes).wait()


def all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    h = _host(mesh, t)
    dist.all_reduce(h)
    mesh.calls["all_reduce"] += 1
    mesh.wire_bytes += _nbytes(h)
    if h is not t:
        t.copy_(h)
    return t


def all_reduce_min(mesh: Mesh, value: int) -> int:
    """The least of an integer over the ranks (agreement checks)."""
    t = torch.tensor([value], dtype=torch.int64)
    h = t.to(mesh.device) if mesh.backend == "nccl" else t
    dist.all_reduce(h, op=dist.ReduceOp.MIN)
    mesh.calls["all_reduce"] += 1
    return int(h.item())


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    h = _host(mesh, t)
    dist.broadcast(h, src)
    mesh.calls["broadcast"] += 1
    if h is not t:
        t.copy_(h)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all), concatenated in rank order."""
    h = _host(mesh, t.contiguous())
    out = [torch.empty_like(h) for _ in range(mesh.world)]
    dist.all_gather(out, h)
    mesh.calls["all_gather"] += 1
    return torch.cat(out).to(t.device)


def barrier(mesh: Mesh) -> None:
    dist.barrier()
    mesh.calls["barrier"] += 1


def scatter_objects(mesh: Mesh, objs: Optional[list]):
    """Rank 0's ``objs[r]`` on rank ``r`` (``objs`` is ignored elsewhere)."""
    out = [None]
    dist.scatter_object_list(out, objs if mesh.rank == 0 else None, src=0)
    return out[0]


def seed_of(seed: int, rank: int) -> int:
    """A generator seed drawn from ``(seed, rank)``."""
    return int(np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0]
               & 0x7FFF_FFFF_FFFF_FFFF)


def env_rank() -> Optional[tuple]:
    """``(rank, world, local_rank)`` when ``torchrun`` launched this
    process, else None."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    return None
