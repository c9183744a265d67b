"""Ranks, devices and collectives of the multi-device path.

The counterpart of ``incagg_gnn_tpu/parallel/mesh.py`` (``make_mesh``,
``make_mesh_2d``, ``init_distributed``) over ``torch.distributed``.  A JAX
mesh is a set of devices one program drives under ``shard_map``; here
each device of the mesh is a rank, one process, and the collectives are
the lockstep.  A mesh is the world group in rank order
(:func:`init_distributed`).  A ``(hosts x chips)`` mesh (``n_hosts`` > 1)
is the same group, host-major (rank = ``host * chips + chip``, the order
JAX's tuple-axis collectives use); it changes only the layout the sharded
trainer chooses (``parallel/layout.py``) and the mesh ``Trainer``'s rows,
sharded over the hosts alone (``parallel/rows.py``).

Each rank gets an explicit ``torch.device`` and an explicit backend
(:func:`place_ranks`): NCCL where every rank has a GPU of its own, gloo on
the CPU and where ranks share one card.  Two ranks on one device with NCCL
are refused; no backend is swapped for another after a failure.  Under gloo
a CUDA tensor is staged through host memory around each collective (gloo
moves host buffers); its seconds are the host wire's.

An all-to-all can stay in flight while the rank computes
(:func:`all_to_all_async`, a :class:`Pending` handle): the sharded
refresh collects its next round's halo that way.

A CUDA graph can hold NCCL collectives (:func:`capture_reason`,
:func:`probe_capture`): one issued inside a capture forks NCCL's stream
from the capturing one, and its handle's ``wait()`` joins it back, so the
graph keeps a collective issued ahead of compute in flight beside that
compute.  Gloo moves host buffers, so a program whose collectives run over
gloo runs eagerly.
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
    host seconds it spent blocked on all-to-all handles (every all-to-all
    is waited through one; inside a CUDA graph's capture a wait records a
    stream dependency and blocks nothing, and a replay calls no wait)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    n_hosts: int = 1
    calls: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(
        ("all_to_all", "all_reduce", "broadcast", "all_gather", "barrier"), 0))
    wire_bytes: int = 0
    wait_s: float = 0.0

    axis_group: object = dataclasses.field(default=None, init=False, repr=False,
                                           compare=False)

    @property
    def chips(self) -> int:
        """The size of the mesh's second axis: the ranks of each host of a
        ``(hosts x chips)`` mesh; 1 on a 1-D mesh, whose one axis is its
        ranks."""
        return self.world // self.n_hosts if self.n_hosts > 1 else 1

    @property
    def row_shards(self) -> int:
        """The size of the mesh's first axis (JAX ``mesh.axis_names[0]``),
        over which a mesh ``Trainer`` shards its rows: ``n_hosts``, or
        every rank of a 1-D mesh."""
        return self.world // self.chips

    @property
    def host(self) -> int:
        """This rank's place on the first axis (ranks are host-major): its
        host on a ``(hosts x chips)`` mesh, its rank on a 1-D mesh."""
        return self.rank // self.chips

    @property
    def chip(self) -> int:
        """This rank's place among its host's ranks."""
        return self.rank % self.chips

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
    orders the current stream after the collective's (inside a capture,
    the graph's edge from the collective to what follows the wait)."""
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


def first_axis_group(mesh: Mesh):
    """The process group of the ranks on this rank's line along the mesh's
    first axis (one rank of each host, all with this rank's chip index),
    or None (the world) on a 1-D mesh.  Made at the first call, which
    every rank makes together: ``dist.new_group`` is collective."""
    if mesh.chips == 1:
        return None
    if mesh.axis_group is None:
        for c in range(mesh.chips):
            g = dist.new_group([h * mesh.chips + c for h in range(mesh.row_shards)])
            if c == mesh.chip:
                mesh.axis_group = g
    return mesh.axis_group


def all_reduce(mesh: Mesh, t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks (of ``group``, else all), in place;
    returns ``t``."""
    h = _host(mesh, t)
    dist.all_reduce(h, group=group)
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


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (of ``group``, else all), in
    place; returns ``t``."""
    h = _host(mesh, t)
    dist.broadcast(h, src, group=group)
    mesh.calls["broadcast"] += 1
    if h is not t:
        t.copy_(h)
    return t


@torch.no_grad()
def broadcast_module(mesh: Mesh, module: torch.nn.Module) -> None:
    """Rank 0's parameters and floating buffers on every rank (one
    broadcast)."""
    ts = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    if mesh.world == 1 or not ts:
        return
    unflatten(broadcast(mesh, torch.cat([t.detach().reshape(-1).float() for t in ts])), ts)


@torch.no_grad()
def unflatten(flat: torch.Tensor, ts: Sequence[torch.Tensor]) -> None:
    """Copy consecutive pieces of ``flat`` into the tensors ``ts``."""
    o = 0
    for t in ts:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


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


def capture_reason(mesh: Optional[Mesh]) -> str:
    """Why a program whose collectives run on ``mesh`` cannot be captured
    as a CUDA graph, or ``""`` when it can (none, or NCCL on CUDA)."""
    if mesh is None:
        return ""
    if mesh.device.type != "cuda":
        return "CUDA graphs need a CUDA device: the collectives run eagerly"
    if mesh.backend != "nccl":
        return (f"{mesh.backend} runs its collectives on the host, which a CUDA graph "
                f"cannot hold: they run eagerly")
    return ""


def probe_capture(mesh: Mesh, rows: int = 4096, cols: int = 64) -> dict:
    """An ``all_reduce``, then an ``all_to_all_single`` issued
    asynchronously with compute between its issue and its wait (as the
    sharded refresh's pipelined pass holds it), captured into one CUDA
    graph (each run eagerly first, as a capture needs) and replayed twice,
    on two inputs, against their eager results: raises unless the replays
    equal them bit for bit; returns the seconds of the capture and of one
    replay."""
    if capture_reason(mesh):
        raise RuntimeError(f"no capture on this mesh: {capture_reason(mesh)}")
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(1000 + mesh.rank)
    a = torch.randn((rows, cols), device=dev, generator=gen)
    b = torch.randn((mesh.world * rows, cols), device=dev, generator=gen)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)

    def step():
        out_a.copy_(a)
        dist.all_reduce(out_a)
        work = dist.all_to_all_single(out_b, b, async_op=True)
        out_a.mul_(2.0)  # in flight beside the all-to-all
        work.wait()

    def eager():
        want_a = a.clone()
        dist.all_reduce(want_a)
        want_a.mul_(2.0)
        want_b = torch.empty_like(b)
        dist.all_to_all_single(want_b, b)
        return want_a, want_b

    step()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        step()
    capture_s = time.perf_counter() - t0
    replay_s = 0.0
    for _ in range(2):
        want_a, want_b = eager()
        out_a.zero_()
        out_b.zero_()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(dev)
        replay_s = time.perf_counter() - t0
        if not (torch.equal(out_a, want_a) and torch.equal(out_b, want_b)):
            raise AssertionError(
                f"a captured collective differs from its eager run: all_reduce "
                f"{float((out_a - want_a).abs().max()):.3e}, all_to_all "
                f"{float((out_b - want_b).abs().max()):.3e}")
        a.add_(1.0)
        b.mul_(0.5)
    return {"capture_s": capture_s, "replay_s": replay_s}


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
