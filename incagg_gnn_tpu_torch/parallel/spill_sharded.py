"""Sharded GAS and Reverb/VR training with the caches in host memory.

The counterpart of ``incagg_gnn_tpu/parallel/spill_sharded.py``: the slab
sharding of :class:`~incagg_gnn_tpu_torch.parallel.spatial.ShardedVRTrainer`
with the host-memory caches of
:class:`~incagg_gnn_tpu_torch.train.spill_trainer.SpillVRTrainer`, for cache
slabs past a card's memory.  Each rank holds only its own slab's ``M_in`` and
``M_ag`` tables (``[slab, D]`` each, a
:class:`~incagg_gnn_tpu_torch.history_spill.SpilledHistory`: pinned on CUDA,
rows gathered and scattered by the shared C++ worker, copied on one copy
stream with an event each), where the JAX trainer holds every device's
tables in one process.  No cache lives on the device between steps.

- **Reverb/VR:** a round stages its batch rows of every layer's tables as
  :class:`~incagg_gnn_tpu_torch.models.base.StreamedPulls` (JAX :107-123).
  Training never writes the caches.
- **GAS:** a round stages the rows its batch reads of layers ``1..L-1``
  (JAX :212-225).  Rows of other ranks' slabs come over the round's halo:
  each rank stages the rows of its own tables that the round's exchange
  reads (its local batch rows and the rows it sends), compacted, and the
  exchange assembles the batch's ``[C_pad, (L-1)*D]``, one all-to-all a
  round.  This round's fresh pushes are spliced in ``push_and_pull``
  (``models/base.py``, the spill + halo branch); after the step each layer's
  in-batch pushes go back to the host tables chunk-contiguously.
- **Refresh:** one layer at a time.  A layer pass reads ``M_in[0]`` and
  ``M_in[l]``, which this sweep wrote earlier (layer 0 writes ``M_in[0]``,
  layer ``l-1`` writes ``M_in[l]``), and writes ``M_in[l+1]`` and
  ``M_ag[l]``, which it covers whole.  So the sweep stages nothing
  host-to-device: each layer pass allocates its two output tables, keeps
  ``M_in[0]`` (where the model reads x0) and its output for the next layer,
  and writes each table back once.  At most four tables are on the device
  at once, not ``2·L``; the results are the device path's bit for bit.

The host tables are in the cache dtype (``hist_dtype``, as the JAX
trainer's), each row padded to whole 4-byte words for the worker; staged
rows reach the device in that dtype and are widened to f32 there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from incagg_gnn_tpu_torch.history import HistoryState
from incagg_gnn_tpu_torch.history_spill import SpilledHistory
from incagg_gnn_tpu_torch.models.base import StreamedPulls
from incagg_gnn_tpu_torch.parallel.plan import HaloPlan
from incagg_gnn_tpu_torch.parallel.spatial import HaloExchange, ShardedVRTrainer
from incagg_gnn_tpu_torch.train.spill_trainer import CopyStaging, _check_spill


def push_chunks(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``rows`` as runs of consecutive rows: ``(offset, count)``."""
    if rows.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = np.flatnonzero(np.diff(rows) != 1) + 1
    bounds = np.concatenate([[0], starts, [rows.size]])
    return rows[bounds[:-1]].astype(np.int64), np.diff(bounds).astype(np.int64)


def compact_halo(plan: HaloPlan, trash: int) -> Tuple[np.ndarray, HaloPlan]:
    """The local slab rows a round's exchange reads (its batch's local rows,
    the rows it sends, the trash row), sorted, and the plan with its slab
    indices renumbered into those rows."""
    need = np.unique(np.concatenate([plan.local_pos, plan.send_idx.ravel(), [trash]])
                     ).astype(np.int64)
    return need, plan._replace(
        send_idx=np.searchsorted(need, plan.send_idx).astype(np.int32),
        local_pos=np.searchsorted(need, plan.local_pos).astype(np.int32))


class ShardedSpillVRTrainer(CopyStaging, ShardedVRTrainer):
    """:class:`ShardedVRTrainer` whose caches live in host memory, one slab a
    rank; refuses what ``train/spill_trainer.py::_check_spill`` refuses."""

    _alloc_device_hist = False
    _no_capture = ("the spill tier stages its cache rows from host memory between the "
                   "steps: they run eagerly")

    def __init__(self, model, data, cfg, mesh, log: bool = False, prepared=None,
                 pool_size: int = 2):
        _check_spill(model, cfg)
        super().__init__(model, data, cfg, mesh, log=log, prepared=prepared)
        L, D = model.cfg.num_layers, model.hist_dim
        slab, trash = self.layout.slab, self.layout.local_trash()
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # staging slots start small and grow to the rows a pull or push needs
        # (pinned memory is allocated for the slots a run uses only)

        def table() -> SpilledHistory:
            return SpilledHistory(slab - 1, D, pool_size=pool_size, buffer_size=8,
                                  device=self.device, copy_stream=self.copy_stream,
                                  dtype=self.hist_dtype)

        self.host_in: List[SpilledHistory] = [table() for _ in range(L)]
        self.host_ag: List[SpilledHistory] = [table() for _ in range(L)]
        self._chunks = [push_chunks(push[:bs]) for push, bs in self._train_push]
        self._stage_rows: List[np.ndarray] = []
        self._stage_halos: List[HaloExchange] = []
        if not self.vr:
            for per in self.plan.train.halos:
                need, plan = compact_halo(per[self.rank], trash)
                self._stage_rows.append(need)
                self._stage_halos.append(HaloExchange(plan, mesh, self.halo_wire))
        self._gas_push_slots: Optional[List[int]] = None
        self._acc: Optional[List[torch.Tensor]] = None
        if log and self.rank == 0:
            mb = sum(t.table_t.nbytes for t in self.tables_host) / 2**20
            print(f"ShardedSpillVRTrainer: {2 * L} host tables of {slab} x {D} "
                  f"{str(self.hist_dtype)[6:]} a rank ({mb:.1f} MB)"
                  f"{', pinned' if self.copy_stream is not None else ''}", flush=True)

    @property
    def tables_host(self) -> List[SpilledHistory]:
        return [*self.host_in, *self.host_ag]

    def _sync_pushes(self) -> None:
        for t in self.host_in:
            t.synchronize_push()

    # ---------------- Reverb/VR: staged pulls ----------------
    def _staging(self, *shape) -> torch.Tensor:
        """Zeros for staged rows: the tables' dtype and row width."""
        return self._zeros(*shape, self.host_in[0].cols, dtype=self.hist_dtype)

    def _widened(self, staged: torch.Tensor) -> torch.Tensor:
        """Staged rows in f32, ``D`` columns."""
        return staged.float()[..., : self.model.hist_dim]

    def _vr_caches(self, i: int) -> StreamedPulls:
        """Round ``i``'s batch rows of every layer's ``M_in`` and ``M_ag``,
        ``[L, R_pad, D]`` f32 each (padded rows zero)."""
        L = self.model.cfg.num_layers
        push, bs = self._train_push[i]
        m_in, m_ag = self._staging(L, len(push)), self._staging(L, len(push))
        if bs:
            self._staged_rows(self.tables_host, push[:bs], [*m_in, *m_ag], 0)
        self._ready(self._copy_event(), m_in, m_ag)
        return StreamedPulls(m_in=self._widened(m_in), m_ag=self._widened(m_ag))

    # ---------------- GAS: staged pulls, the fresh-push splice, write-back ----------------
    def _stage_gas_pulls(self, i: int) -> torch.Tensor:
        """``[L, C_pad, D]`` f32: round ``i``'s batch rows (``n_id``, global
        rows) of layers ``1..L-1`` from the ranks' host tables; slot 0 stays
        zero (layer 0 reads the features)."""
        L, D = self.model.cfg.num_layers, self.model.hist_dim
        c_pad = self._train[i].n_id.shape[0]
        out = torch.zeros((L, c_pad, D), device=self.device)
        if L > 1:
            need = self._stage_rows[i]
            staged = self._staging(L - 1, len(need))
            self._staged_rows(self.host_in[1:], need, list(staged), 0)
            self._ready(self._copy_event(), staged)
            src = self._widened(staged).permute(1, 0, 2).reshape(len(need), (L - 1) * D)
            ex = self._stage_halos[i]
            got = ex.assemble(src, ex.collect(src))
            out[1:] = got.view(c_pad, L - 1, D).permute(1, 0, 2)
        return out

    def _gas_forward(self, i: int, x: torch.Tensor, batch,
                     exchange: HaloExchange) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        L, D = model.cfg.num_layers, model.hist_dim
        pulled = self._stage_gas_pulls(i)
        r_pad = batch.push_idx.shape[0]
        acc = [torch.zeros((r_pad, D), device=self.device) for _ in range(L)]
        slots: set = set()
        model._stream_pulled, model._stream_pushed_slots = pulled, slots
        model._shard_halo, model._spill_slab_rows = exchange, self.layout.slab
        try:
            out, _ = model.forward_gas(x, batch, acc, self.generator, True,
                                       aggregate_combined=cfg.aggregate_combined,
                                       use_aggregation=cfg.use_aggregation)
        finally:
            model._stream_pulled = model._stream_pushed_slots = None
            model._shard_halo = model._spill_slab_rows = None
        if self._gas_push_slots is None:
            self._gas_push_slots = sorted(slots)
        self._acc = acc
        return out

    def _after_gas_step(self, i: int) -> None:
        """Each pushed layer's in-batch rows back to the host tables (JAX
        :227-274), in the cache dtype."""
        acc, self._acc = self._acc, None
        _, bs = self._train_push[i]
        if not bs:
            return
        offset, count = self._chunks[i]
        for slot in self._gas_push_slots:
            self.host_in[slot].async_push(acc[slot][:bs], offset=offset, count=count)

    def train_epoch(self) -> Dict[str, float]:
        out = super().train_epoch()
        self._sync_pushes()  # the epoch's write-back has landed in the tables
        return out

    # ---------------- refresh: layer by layer, written back once ----------------
    @torch.no_grad()
    def refresh(self, host_logits: bool = True) -> Optional[np.ndarray]:
        self._steps_since_refresh = 0
        self._sync_pushes()
        model = self.model
        L, D = model.cfg.num_layers, model.hist_dim

        def table() -> torch.Tensor:
            return torch.zeros((self.layout.slab, D), dtype=self.hist_dtype,
                               device=self.device)

        def write_back(host: SpilledHistory, t: torch.Tensor) -> None:
            t[-1].zero_()  # the trash row
            host.push_table(t)

        emb0 = cur = table()
        for layer in range(L):
            emb: List[Optional[torch.Tensor]] = [None] * L
            emb_ag: List[Optional[torch.Tensor]] = [None] * L
            emb[0], emb[layer] = emb0, cur
            nxt = table() if layer < L - 1 else None
            if nxt is not None:
                emb[layer + 1] = nxt
            emb_ag[layer] = table()
            self._refresh_layer(layer, HistoryState(emb=emb, emb_ag=emb_ag))
            if layer == 0:
                write_back(self.host_in[0], emb0)
                if not model.needs_x0:
                    emb0 = None
            if nxt is not None:
                write_back(self.host_in[layer + 1], nxt)
            write_back(self.host_ag[layer], emb_ag[layer])
            del emb, emb_ag
            cur = nxt
        del emb0, cur
        if not host_logits:
            return None
        return self.logits()

    fill_history = refresh

    # ---------------- checkpoint protocol: the host tables ----------------
    def hist_arrays(self) -> Dict[str, torch.Tensor]:
        """This rank's host tables (every queued push landed) and its
        generator, under the device path's names."""
        self._sync_pushes()
        D = self.model.hist_dim
        return {**{f"hist.emb.{l}": t.table_t[:, :D] for l, t in enumerate(self.host_in)},
                **{f"hist.emb_ag.{l}": t.table_t[:, :D] for l, t in enumerate(self.host_ag)},
                "generator": self.generator.get_state()}
