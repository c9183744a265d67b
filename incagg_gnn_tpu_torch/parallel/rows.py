"""Row-sharded tables: the state of a mesh ``Trainer``.

The counterpart of the JAX trainer's ``NamedSharding(mesh, P(ax))``
placements (``incagg_gnn_tpu/train/trainer.py:308-345``).  A mesh
``Trainer`` runs one program on every rank: the same batches, the same
parameters and the same dropout draws.  What it shards is its state of
``[N+1, ...]`` rows: each history cache, the feature, label and mask
tables, and the logits table.  Rows are padded to ``rows_pad =
ceil((N+1)/n)·n`` over the ``n`` ranks, as JAX pads them to the mesh's
device count, and sharded over the mesh's first axis only
(``mesh.axis_names[0]``, ``Mesh.row_shards``): the hosts of a ``(hosts x
chips)`` mesh, every rank of a 1-D mesh (one chip a host).  Host ``h``
holds rows ``[h·S, (h+1)·S)`` with ``S = rows_pad / hosts``
(:class:`RowSharded`), and every chip of a host holds the same slab.

- **Pull** of rows ``idx``: each rank gathers the rows of ``idx`` that
  lie in its host's slab and writes ``-0.0`` for the others.  Then one
  ``all_reduce`` (SUM) adds them up over the first axis only
  (``mesh.py::first_axis_group``: one rank of each host, those with this
  rank's chip index; the world on a 1-D mesh), so each chip reads its own
  replica and a host's chips reduce side by side.  This is the masked
  gather plus all-reduce over the sharded axis that GSPMD emits for a take
  from a row-sharded operand.  Each row has exactly one contributor in
  each group, and ``x + (-0.0)`` is ``x`` for every ``x``, so the result is
  the unsharded pull bit for bit.  Floating rows travel in f32 (the pull
  upcasts bf16 and fp8 anyway), integer and boolean rows in int64.
- **Push**: every rank writes the rows of its host's slab.  The values are
  the same on every rank, so no collective runs and a host's chips stay
  equal.  The other rows land in one scratch row past the slab, which no
  pull reads.
- **The trash row** ``N`` belongs to one host: every rank of it zeroes it.
- **Gathers** (the whole table on the host, a split's counts) run over
  the first axis as the pull does: each slab counted once in each group.

:class:`RowSharded` registers its forms of ``history.py``'s ``pull``,
``push``, ``fill``, ``zero_trash_row`` and ``local_rows``, and
:class:`RowTables` its form of ``train/steps.py::table_inputs``, so the
models and steps run their single-device code.  Parameters stay one value
on every rank: :class:`MeshOptimizer` applies rank 0's gradient and
BatchNorm statistics on all of them.

Under NCCL the collectives can be captured into a CUDA graph; gloo moves
host buffers and cannot (``mesh.py::capture_reason``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from incagg_gnn_tpu_torch import history as H
from incagg_gnn_tpu_torch.graph.csr import GraphData
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel.mesh import Mesh
from incagg_gnn_tpu_torch.train import steps
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.tables import table_arrays
from incagg_gnn_tpu_torch.utils.metrics import split_counts, split_metrics_from_counts


def rows_pad(num_rows: int, world: int) -> int:
    """``num_rows`` padded to a multiple of ``world`` (JAX trainer.py:315)."""
    return -(-num_rows // world) * world


def slab_rows(num_rows: int, mesh: Mesh) -> int:
    """Rows of each host's slab: ``rows_pad(num_rows, world) / hosts``."""
    return rows_pad(num_rows, mesh.world) // mesh.row_shards


def check_mesh(mesh: Mesh, device) -> None:
    """Refuse a trainer device that is not the mesh rank's."""
    if torch.device(device) != mesh.device:
        raise ValueError(f"Trainer device {device} is not the mesh rank's device "
                         f"{mesh.device}")


class RowSharded:
    """One ``[num_rows, ...]`` table sharded by rows over the mesh's hosts:
    this rank's host's slab of ``S`` rows (:attr:`slab`), stored with one
    scratch row after it (:attr:`storage`, ``[S + 1, ...]``)."""

    def __init__(self, mesh: Mesh, num_rows: int, storage: torch.Tensor):
        self.mesh, self.num_rows, self.storage = mesh, num_rows, storage
        self.slab_rows = storage.shape[0] - 1
        self.lo = mesh.host * self.slab_rows

    @classmethod
    def zeros(cls, mesh: Mesh, num_rows: int, tail: Tuple[int, ...],
              dtype: torch.dtype) -> "RowSharded":
        s = slab_rows(num_rows, mesh)
        return cls(mesh, num_rows, torch.zeros((s + 1, *tail), dtype=dtype,
                                               device=mesh.device))

    @classmethod
    def of(cls, mesh: Mesh, full: np.ndarray,
           dtype: Optional[torch.dtype] = None) -> "RowSharded":
        """This rank's host's slab of the host array ``full`` (every rank
        holds the same ``full``); nothing else of it reaches the device."""
        s = slab_rows(full.shape[0], mesh)
        lo = mesh.host * s
        part = np.zeros((s + 1,) + full.shape[1:], full.dtype)
        own = full[lo:lo + s]
        part[:len(own)] = own
        t = torch.from_numpy(part).to(mesh.device)
        return cls(mesh, full.shape[0], t if dtype is None else t.to(dtype))

    # -- what code that keys on a table reads ------------------------------
    @property
    def slab(self) -> torch.Tensor:
        return self.storage[:-1]

    @property
    def shape(self) -> Tuple[int, ...]:
        """The padded global shape, ``[rows_pad, ...]``."""
        return (self.slab_rows * self.mesh.row_shards, *self.storage.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.storage.dtype

    @property
    def device(self) -> torch.device:
        return self.storage.device

    def numel(self) -> int:
        """Elements this rank holds (its slab)."""
        return self.slab.numel()

    def element_size(self) -> int:
        return self.storage.element_size()

    def data_ptr(self) -> int:
        return self.storage.data_ptr()

    # -- rows --------------------------------------------------------------
    def _local(self, idx: torch.Tensor):
        """Which of ``idx`` this rank owns, and where each lies in the
        storage (the scratch row for the others)."""
        loc = idx.long() - self.lo
        own = (loc >= 0) & (loc < self.slab_rows)
        return own, torch.where(own, loc, self.slab_rows)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the whole table on every rank: f32 for floating
        tables, int64 for the others (one ``all_reduce`` over the mesh's
        first axis, in which each row has one contributor)."""
        floating = self.dtype.is_floating_point
        wire, zero = (torch.float32, -0.0) if floating else (torch.int64, 0)
        own, at = self._local(idx)
        rows = self.storage.index_select(0, at)
        own = own.view((-1,) + (1,) * (rows.ndim - 1))
        out = torch.where(own, rows.to(wire), zero)
        return M.all_reduce(self.mesh, out, M.first_axis_group(self.mesh))

    @torch.no_grad()
    def put(self, idx: torch.Tensor, values: torch.Tensor) -> None:
        """Write ``values`` into the rows ``idx`` of this rank's slab (every
        chip of a host writes the same rows)."""
        _, at = self._local(idx)
        table, values = self.storage, values.detach().to(self.dtype)
        if table.element_size() == 1:
            # torch has no index_copy_ for float8: copy the bytes
            table, values = table.view(torch.uint8), values.view(torch.uint8)
        table.index_copy_(0, at, values)

    @torch.no_grad()
    def assign(self, full: torch.Tensor) -> None:
        """Set this rank's host's slab from the whole table ``full`` (its rows
        ``[0, num_rows)``, on any device)."""
        own = full[self.lo:self.lo + self.slab_rows]
        self.slab[:own.shape[0]].copy_(own.to(device=self.device, dtype=self.dtype))

    def to_host(self) -> torch.Tensor:
        """The whole table on the host, ``[num_rows, ...]``: the slabs
        broadcast in host order over the mesh's first axis, each from the
        rank of its host with this rank's chip index, through one
        slab-sized buffer, so no rank holds more than its slab on the
        device."""
        s, tail, mesh = self.slab_rows, tuple(self.storage.shape[1:]), self.mesh
        out = torch.empty((s * mesh.row_shards, *tail), dtype=self.dtype)
        buf = torch.empty_like(self.slab)
        group = M.first_axis_group(mesh)
        for h in range(mesh.row_shards):
            if h == mesh.host:
                buf.copy_(self.slab)
            # bytes travel: gloo and NCCL have no float8 (nor gloo bool)
            M.broadcast(mesh, buf.view(-1).view(torch.uint8),
                        src=h * mesh.chips + mesh.chip, group=group)
            out[h * s:(h + 1) * s] = buf.cpu()
        return out[:self.num_rows]


@H.pull.register
def _pull(table: RowSharded, n_id: torch.Tensor) -> torch.Tensor:
    return table.take(n_id)


@H.push.register
def _push(table: RowSharded, idx: torch.Tensor, values: torch.Tensor) -> None:
    table.put(idx, values)


@H.fill.register
def _fill(table: RowSharded, full: torch.Tensor) -> None:
    table.assign(full)


@H.zero_trash_row.register
@torch.no_grad()
def _zero_trash_row(table: RowSharded) -> None:
    row = table.num_rows - 1 - table.lo
    if 0 <= row < table.slab_rows:
        table.storage[row].zero_()


@H.local_rows.register
def _local_rows(table: RowSharded) -> torch.Tensor:
    return table.slab


class RowTables(NamedTuple):
    """``DeviceTables`` sharded by rows: each field a :class:`RowSharded`."""

    x: RowSharded
    y: RowSharded
    train_mask: RowSharded
    val_mask: RowSharded
    test_mask: RowSharded


@steps.table_inputs.register
def _table_inputs(tables: RowTables, batch):
    x = tables.x.take(batch.n_id)
    y = tables.y.take(batch.push_idx)
    mask = tables.train_mask.take(batch.push_idx).bool()
    rows = torch.arange(batch.push_idx.shape[0], device=mask.device)
    return x, y, mask & (rows < batch.batch_size)


def shard_tables(data: GraphData, mesh: Mesh,
                 dtype: torch.dtype = torch.float32) -> RowTables:
    """``train/tables.py::make_tables`` by rows: each rank's slab only."""
    x, *rest = table_arrays(data)
    return RowTables(RowSharded.of(mesh, x, dtype), *(RowSharded.of(mesh, a) for a in rest))


def shard_history(mesh: Mesh, num_layers: int, num_nodes: int, dim: int,
                  dtype: torch.dtype) -> H.HistoryState:
    """``history.py::init_history`` by rows."""
    def z():
        return RowSharded.zeros(mesh, num_nodes + 1, (dim,), dtype)

    return H.HistoryState(emb=[z() for _ in range(num_layers)],
                          emb_ag=[z() for _ in range(num_layers)])


def split_count_totals(out: RowSharded, tables: RowTables) -> torch.Tensor:
    """``utils/metrics.py::split_counts`` of the whole table: each rank
    counts its host's slab, one ``all_reduce`` over the mesh's first axis
    sums the counts (exact in int64)."""
    counts = split_counts(out.slab, tables.y.slab, (tables.train_mask.slab,
                                                    tables.val_mask.slab,
                                                    tables.test_mask.slab))
    return M.all_reduce(out.mesh, counts, M.first_axis_group(out.mesh))


def split_metrics(out: RowSharded, tables: RowTables):
    """``split_metrics_device`` over row-sharded tables."""
    return split_metrics_from_counts(split_count_totals(out, tables),
                                     tables.y.slab.ndim > 1)


class MeshOptimizer(Optimizer):
    """:class:`Optimizer` of a mesh ``Trainer``: before each step, rank
    0's gradients and BatchNorm running statistics are broadcast (one
    ``broadcast``), then every rank applies the same Adam step, so the
    parameters stay one value as GSPMD's do.  Every rank computed the same
    gradient already where the compute is deterministic; the broadcast
    also keeps atomic sums (COO's ``index_add_``) from splitting them."""

    def __init__(self, mesh: Mesh, model: torch.nn.Module, *args, **kw):
        super().__init__(model, *args, **kw)
        self.mesh = mesh
        self._stats = [b for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))]

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ts = [p.grad for p in self.params] + self._stats
        flat = M.broadcast(self.mesh, torch.cat([t.reshape(-1) for t in ts]))
        M.unflatten(flat, ts)
        super().step()
