"""Training steps, GAS and Reverb/VR (port of
``incagg_gnn_tpu/train/steps.py``; reference: one ``mini_train`` iteration,
main.py:58-92): edge dropout, feature gather, forward, masked loss,
backward, clip + Adam.  GAS forwards write the history in place as they go.

The fused epoch (:class:`EpochGraph`, ``make_gas_epoch_graph``,
``make_vr_epoch_graph``) is the counterpart of the JAX package's
``make_*_epoch_scan``: one step over static batch buffers
(:class:`StaticBatch`), captured once as a CUDA graph and replayed for
every batch of the epoch.  :func:`capture_graph` is the capture both it and
the refresh sweep's graphs (``models/base.py``) go through."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.loader import SubgraphBatch, _tensors
from incagg_gnn_tpu_torch.models.nn import edge_dropout
from incagg_gnn_tpu_torch.ops.kernels import add_launches, launch_counts
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.tables import DeviceTables


def masked_loss(out: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                multilabel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE (single-label) / BCE-with-logits (multi-label) over the
    masked rows, and the row count (reference: main.py:153-156, 80)."""
    m = mask.float()
    count = m.sum().clamp(min=1.0)
    if multilabel:
        per = F.binary_cross_entropy_with_logits(out, y, reduction="none").mean(-1)
    else:
        per = F.cross_entropy(out, y, reduction="none")
    return (per * m).sum() / count, m.sum()


def batch_inputs(batch, tables: DeviceTables):
    """Features of the batch's columns, labels and train mask of its rows."""
    x = tables.x.index_select(0, batch.n_id).float()
    y = tables.y.index_select(0, batch.push_idx)
    mask = tables.train_mask.index_select(0, batch.push_idx)
    rows = torch.arange(batch.push_idx.shape[0], device=mask.device)
    return x, y, mask & (rows < batch.batch_size)


def drop_edges(batch, generator: Optional[torch.Generator], p: float,
               weighted: bool):
    """The batch with DropEdge applied to its COO adjacency's values (the
    trainer sends ``edge_dropout > 0`` to the COO format)."""
    if p == 0.0:
        return batch
    adj = batch.adj
    vals = edge_dropout(adj.vals, p, True, generator, weighted)
    return batch._replace(adj=adj.with_values(vals))


def gas_loss(model, batch, tables: DeviceTables, hist_emb,
             generator: Optional[torch.Generator], multilabel: bool = False,
             use_aggregation: bool = True, aggregate_combined: bool = True,
             edge_dropout_p: float = 0.0,
             weighted_adj: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """GAS forward + masked loss (the forward pushes into ``hist_emb``)."""
    batch = drop_edges(batch, generator, edge_dropout_p, weighted_adj)
    x, y, mask = batch_inputs(batch, tables)
    out, aux = model.forward_gas(x, batch, hist_emb, generator, True,
                                 aggregate_combined=aggregate_combined,
                                 use_aggregation=use_aggregation)
    loss, n = masked_loss(out, y, mask, multilabel)
    return loss, n, aux


def vr_loss(model, batch, tables: DeviceTables, hist: HistoryState,
            generator: Optional[torch.Generator], multilabel: bool = False,
            drift_norm: int = 2, edge_dropout_p: float = 0.0,
            weighted_adj: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Reverb/VR forward on an in-batch-only batch + masked loss; the
    caches are read only."""
    batch = drop_edges(batch, generator, edge_dropout_p, weighted_adj)
    x, y, mask = batch_inputs(batch, tables)
    out, aux = model.forward_vr(x, batch, hist, generator, True, drift_norm)
    loss, n = masked_loss(out, y, mask, multilabel)
    return loss, n, aux


def train_step(opt: Optimizer, loss: torch.Tensor, n: torch.Tensor,
               aux: Dict) -> Dict:
    """Backward and one optimizer step; returns the step's metrics."""
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "num_train": n,
            **{k: v.detach() for k, v in aux.items()}}


def _clone(obj):
    """A copy of a container tree's tensors, the tree rebuilt around them."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_clone(v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_clone(v) for v in obj)
    return obj


def _arrays(obj):
    """The tensors and numpy arrays of a container tree (a batch held on
    the device, or on the host before staging)."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _arrays(v)


def batch_shape(batch: SubgraphBatch) -> tuple:
    """What a captured step depends on: the adjacency's format and every
    array's shape and dtype (the batch's counts are device values)."""
    return (type(batch.adj).__name__,
            tuple((tuple(a.shape), a.dtype) for a in _arrays(batch)))


def batch_bytes(batch: SubgraphBatch) -> int:
    """Bytes of a batch's arrays, on the device or on the host."""
    return sum(a.nbytes if isinstance(a, np.ndarray) else a.numel() * a.element_size()
               for a in _arrays(batch))


def capture_graph(step: Callable[[], None], generator: Optional[torch.Generator] = None,
                  pool=None, keep_graph: bool = False) -> Tuple[object, Dict[str, int]]:
    """``step`` captured as a CUDA graph: returns the graph and what one
    replay launches, by wrapper name.  The capture launches nothing, so the
    launch counters it bumped are taken back; a replay calls no wrapper, so
    its runner adds the returned counts (:func:`replay`).  ``generator`` is
    registered with the graph (each replay draws anew from it); ``pool`` is
    a memory pool shared with other graphs (``torch.cuda.graph_pool_handle``)
    that are replayed one at a time; with ``keep_graph`` the captured
    ``cudaGraph_t`` is kept beside its instance (``raw_cuda_graph()``)."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True) if keep_graph else torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # thread_local: the loader's staging threads may allocate meanwhile
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        step()
    after = launch_counts()
    per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    add_launches({k: -v for k, v in per.items()})
    return graph, per


def replay(graph, launches_per_replay: Dict[str, int]) -> None:
    """One replay of a captured graph, its launches added to the counters."""
    graph.replay()
    add_launches(launches_per_replay)


class StaticBatch:
    """Static buffers of one batch shape, the batch's row and column counts
    in device scalars: what a captured step reads, each batch copied in
    (:meth:`load`) before a replay."""

    def __init__(self, batch: SubgraphBatch):
        device = batch.n_id.device
        self.shape = batch_shape(batch)
        self.batch = _clone(batch)._replace(
            batch_size=torch.tensor(batch.batch_size, device=device),
            num_nodes=torch.tensor(batch.num_nodes, device=device))
        self._bufs = list(_tensors(self.batch._replace(batch_size=None, num_nodes=None)))

    def load(self, batch: SubgraphBatch) -> None:
        """Copy ``batch`` (of this shape) into the buffers, on the current
        stream."""
        for dst, src in zip(self._bufs, _tensors(batch)):
            dst.copy_(src)
        self.batch.batch_size.fill_(batch.batch_size)
        self.batch.num_nodes.fill_(batch.num_nodes)


class EpochGraph:
    """A training epoch as replays of one step (the JAX package's scanned
    epoch, ``make_*_epoch_scan``).

    The batches of an epoch share one shape; each is copied into static
    buffers of that shape (its row and column counts into device scalars),
    and the step runs on them: forward and masked loss (``loss_fn``),
    backward, clip + Adam, the GAS pushes into the caches in place, and
    ``loss · n`` and ``n`` summed on the device.  On CUDA the step is
    captured once per batch shape as a CUDA graph, after one eager run of
    it on the first batch (a real step, which also builds the kernels, the
    allocator's blocks and Adam's state), and replayed for every later
    batch; the trainer's generator is registered with the graph, so every
    replay draws new dropout masks.  On the CPU the same step runs eagerly
    on the same buffers.  A failed capture or replay raises.

    A replay launches the captured kernels without calling their wrappers:
    ``launches_per_replay`` holds what one replay launches (by wrapper
    name), which each replay adds to the counters.  With ``keep_graph``
    set (on the class, before a capture) the captured ``cudaGraph_t`` is
    kept beside its instance (``torch.cuda.CUDAGraph(keep_graph=True)``),
    so that a check can read its nodes through ``raw_cuda_graph()``."""

    keep_graph = False

    def __init__(self, loss_fn: Callable, opt: Optimizer,
                 generator: Optional[torch.Generator] = None):
        self.loss_fn, self.opt, self.generator = loss_fn, opt, generator
        self._static: Optional[StaticBatch] = None
        self._graph = None
        self._acc: Optional[torch.Tensor] = None  # [Σ loss·n, Σ n]
        self.launches_per_replay: Dict[str, int] = {}
        self.captures = 0

    def _load(self, batch: SubgraphBatch) -> None:
        """Copy ``batch`` into the static buffers, (re)made for a new shape."""
        if self._static is None or batch_shape(batch) != self._static.shape:
            self._graph = None
            self._static = StaticBatch(batch)
            return
        self._static.load(batch)

    def _step(self) -> None:
        loss, n = self.loss_fn(self._static.batch)
        self.opt.zero_grad()
        loss.backward()
        self.opt.step()
        self._acc.add_(torch.stack([loss.detach() * n, n]))

    def _capture(self) -> None:
        self.opt.zero_grad()  # the gradients are allocated in the graph's pool
        self._graph, self.launches_per_replay = capture_graph(
            self._step, self.generator, keep_graph=self.keep_graph)
        self.captures += 1

    def __call__(self, batches: Sequence[SubgraphBatch]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train one step on each of ``batches`` (device batches of one
        shape, each with a train row); returns the device scalars (mean
        loss over the train rows, train rows)."""
        if not batches:
            raise ValueError("an epoch of no batches")
        if self._acc is None:
            self._acc = torch.zeros(2, device=batches[0].n_id.device)
        self._acc.zero_()
        cuda = self._acc.device.type == "cuda"
        for i, batch in enumerate(batches):
            self._load(batch)
            if not cuda or (self._graph is None and i == 0):
                self._step()
                continue
            if self._graph is None:
                self._capture()
            replay(self._graph, self.launches_per_replay)
        total, n = self._acc[0], self._acc[1]
        return total / n.clamp(min=1.0), n


def make_gas_epoch_graph(model, opt: Optimizer, tables: DeviceTables, hist_emb,
                         generator: Optional[torch.Generator], multilabel: bool = False,
                         aggregate_combined: bool = True,
                         use_aggregation: bool = True) -> EpochGraph:
    """The GAS epoch (JAX ``make_gas_epoch_scan``): each step pushes into
    ``hist_emb`` in place and pulls the out-of-batch rows from it."""
    def loss_fn(batch):
        loss, n, _ = gas_loss(model, batch, tables, hist_emb, generator, multilabel,
                              use_aggregation, aggregate_combined)
        return loss, n
    return EpochGraph(loss_fn, opt, generator)


def make_vr_epoch_graph(model, opt: Optimizer, tables: DeviceTables, hist: HistoryState,
                        generator: Optional[torch.Generator], multilabel: bool = False,
                        drift_norm: int = 2) -> EpochGraph:
    """The Reverb/VR epoch (JAX ``make_vr_epoch_scan``): the caches are read
    only."""
    def loss_fn(batch):
        loss, n, _ = vr_loss(model, batch, tables, hist, generator, multilabel,
                             drift_norm)
        return loss, n
    return EpochGraph(loss_fn, opt, generator)
