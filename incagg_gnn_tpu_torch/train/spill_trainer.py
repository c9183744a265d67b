"""Training with host-memory (spilled) history caches.

Port of ``incagg_gnn_tpu/train/spill_trainer.py``.  For graphs whose caches
outgrow the device, the ``M_in``/``M_ag`` stacks live in host memory as
:class:`~incagg_gnn_tpu_torch.history_spill.SpilledHistory` tables (pinned
on CUDA) — the reference's pinned-CPU histories and async pool, with the C++
staging worker (``csrc/spill.cpp``) and copy-engine transfers on one copy
stream shared by every table.

- **Reverb/VR step:** the batch's in-batch rows of every layer's ``M_in``
  and ``M_ag`` are gathered on the worker and copied to the device on the
  prefetch thread, two batches ahead (the step only reads the caches); the
  model receives them as :class:`~incagg_gnn_tpu_torch.models.base.StreamedPulls`.
- **GAS step:** the out-of-batch rows of layers ``1..L-1`` are staged at
  the start of the step, after the previous step's pushes were queued on
  the FIFO worker, so they read those pushes (the device path's order);
  the step's in-batch pushes leave in per-layer accumulators and go back to
  the host tables chunk-contiguously through (``offset``, ``count``).  The
  pushed slots are recorded on the first step.
- **Refresh:** layer by layer over the eval batches, each layer's rows
  pulled ``pool_size - 1`` batches ahead, then ``forward_layer`` and the
  ``M_ag`` value on the device, pushed back chunk-contiguously.

The tables are float32 whatever ``hist_dtype`` says, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from incagg_gnn_tpu_torch.graph.csr import GraphData
from incagg_gnn_tpu_torch.history import push
from incagg_gnn_tpu_torch.history_spill import SpilledHistory
from incagg_gnn_tpu_torch.models.base import ScalableGNN, StreamedPulls, valid_rows
from incagg_gnn_tpu_torch.models.nn import pad_cols
from incagg_gnn_tpu_torch.train.steps import gas_loss, train_step, vr_loss
from incagg_gnn_tpu_torch.train.trainer import PREFETCH_DEPTH, Trainer, TrainerConfig
from incagg_gnn_tpu_torch.utils.heartbeat import beat
from incagg_gnn_tpu_torch.utils.prefetch import prefetch


def _check_spill(model: ScalableGNN, cfg: TrainerConfig) -> None:
    if model.__class__.__name__ == "PNA_JK":
        raise NotImplementedError(
            "the spill tier with PNA_JK: its refresh reads every layer's cache "
            "for the JK head (the JAX spill trainer has no such path either)")
    if not cfg.use_aggregation:
        raise NotImplementedError("the spill tier with use_aggregation=false")
    if (cfg.hist_momentum > 0.0 or 0.0 < cfg.refresh_frac < 1.0
            or cfg.period_updates_in_one_epoch > 0 or cfg.refresh_drift_threshold > 0.0):
        raise NotImplementedError(
            "the spill tier refreshes whole caches once per epoch, as the JAX "
            "spill trainer does: hist_momentum, refresh_frac, "
            "period_updates_in_one_epoch and refresh_drift_threshold are not "
            "available with it")


class CopyStaging:
    """Rows of the host tables ``self.tables_host`` staged to ``self.device``
    on one copy stream (``self.copy_stream``, None off CUDA), shared by the
    single-device and the sharded spill tier."""

    copy_stream: Optional["torch.cuda.Stream"]
    device: torch.device
    tables_host: List[SpilledHistory]

    def spill_bytes(self) -> Dict[str, int]:
        """Bytes staged host-to-device and device-to-host so far."""
        return {"h2d": sum(t.bytes_h2d for t in self.tables_host),
                "d2h": sum(t.bytes_d2h for t in self.tables_host)}

    def _zeros(self, *shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Zeros on the device, written on the copy stream (the staged rows
        are copied into them there)."""
        ctx = (torch.cuda.stream(self.copy_stream) if self.copy_stream is not None
               else contextlib.nullcontext())
        with ctx:
            return torch.zeros(shape, dtype=dtype, device=self.device)

    def _copy_event(self) -> Optional[torch.cuda.Event]:
        """An event that completes after every copy issued so far on the
        copy stream; None off CUDA."""
        if self.copy_stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.copy_stream)
        return event

    def _ready(self, event: Optional[torch.cuda.Event], *tensors) -> None:
        """Order the current stream after the copies ``event`` closes, and
        tell the allocator that it uses ``tensors`` (copy-stream memory)."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)

    @staticmethod
    def _staged_rows(tables: List[SpilledHistory], idx: np.ndarray,
                     outs, start: int) -> None:
        """Copy rows ``idx`` of ``tables[j]`` into ``outs[j][start:]`` (every
        pull issued first, then consumed in FIFO order, pool.py:64-99)."""
        for t in tables:
            t.async_pull(idx)
        for t, out in zip(tables, outs):
            t.synchronize_pull(out=out[start:start + len(idx)], wait=False)
            t.free_pull()


class SpillVRTrainer(CopyStaging, Trainer):
    """Trainer whose caches live in host memory (the reference's operating
    mode), in GAS or Reverb/VR mode; partitioning, loaders, parameters and
    the optimizer are the :class:`Trainer`'s."""

    #: the refresh stages batch-local rows from the host tables
    global_refresh = False

    def __init__(self, model: ScalableGNN, data: GraphData, cfg: TrainerConfig,
                 device, pool_size: int = 3, log: bool = False,
                 debug_verify: bool = False):
        _check_spill(model, cfg)
        super().__init__(model, data, cfg, device, log=log)
        self.vr = cfg.vr_update
        L, D = model.cfg.num_layers, model.hist_dim
        n = self.data.num_nodes
        # slots sized for a training batch's rows; the refresh's column pulls
        # grow only the slots they use (pinned memory is costly to allocate)
        buf = self.train_loader.buckets.rows + 8
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

        def table() -> SpilledHistory:
            return SpilledHistory(n, D, pool_size=pool_size, buffer_size=buf,
                                  device=self.device, debug_verify=debug_verify,
                                  copy_stream=self.copy_stream)

        self.spill_in: List[SpilledHistory] = [table() for _ in range(L)]
        # M_ag tables exist in Reverb mode only; GAS keeps the layer inputs
        self.spill_ag: List[SpilledHistory] = [table() for _ in range(L)] if self.vr else []
        self._gas_push_slots: Optional[List[int]] = None

    def _make_caches(self):
        return None  # the host tables are made in __init__

    @property
    def tables_host(self) -> List[SpilledHistory]:
        return [*self.spill_in, *self.spill_ag]

    # ---------------- training ----------------
    def _stage_pulls(self, hb):
        """The batch's in-batch rows of every layer's ``M_in`` and ``M_ag``
        on the device, padded to ``R_pad``, and the event that closes their
        copies."""
        L, D = self.model.cfg.num_layers, self.model.hist_dim
        r_pad = int(hb.device.push_idx.shape[0])
        idx = hb.n_id[: hb.batch_size]
        m_in, m_ag = self._zeros(L, r_pad, D), self._zeros(L, r_pad, D)
        for l in range(L):
            self._staged_rows([self.spill_in[l], self.spill_ag[l]], idx,
                              [m_in[l], m_ag[l]], 0)
        return StreamedPulls(m_in=m_in, m_ag=m_ag), self._copy_event()

    def _train_batches(self):
        if not self.vr:
            # GAS stages its pulls in the step, after the previous step's
            # pushes; only the collate runs ahead (it reads the graph only)
            return super()._train_batches()

        def staged():
            for hb in self.train_loader:
                if not self._train_mask_host[hb.n_id[: hb.batch_size]].any():
                    continue
                yield hb, self._stage_pulls(hb)

        return prefetch(staged(), PREFETCH_DEPTH)

    def _stage_gas_pulls(self, hb) -> torch.Tensor:
        """The batch's out-of-batch rows of layers ``1..L-1`` in a ``[L,
        C_pad, D]`` stack aligned with ``n_id`` (they sit at ``batch_size:``),
        ready on the current stream."""
        L, D = self.model.cfg.num_layers, self.model.hist_dim
        c_pad = int(hb.device.n_id.shape[0])
        bs = hb.batch_size
        ob = hb.n_id[bs:]
        out = self._zeros(L, c_pad, D)
        if len(ob) and L > 1:
            self._staged_rows(self.spill_in[1:], ob, out[1:], bs)
        self._ready(self._copy_event(), out)
        return out

    def step(self, hb, staged=None) -> Dict:
        cfg = self.cfg
        drop = dict(edge_dropout_p=cfg.edge_dropout, weighted_adj=self.weighted_adj)
        if self.vr:
            pulls, event = staged
            self._ready(event, pulls.m_in, pulls.m_ag)
            loss, n, aux = vr_loss(self.model, hb.device, self.tables, pulls,
                                   self.generator, self.multilabel,
                                   cfg.drift_norm, **drop)
            return train_step(self.opt, loss, n, aux)
        model = self.model
        L, D = model.cfg.num_layers, model.hist_dim
        r_pad = int(hb.device.push_idx.shape[0])
        pulled = self._stage_gas_pulls(hb)
        acc = [torch.zeros((r_pad, D), device=self.device) for _ in range(L)]
        slots: set = set()
        model._stream_pulled, model._stream_pushed_slots = pulled, slots
        try:
            loss, n, aux = gas_loss(model, hb.device, self.tables, acc,
                                    self.generator, self.multilabel,
                                    cfg.use_aggregation, cfg.aggregate_combined,
                                    **drop)
        finally:
            model._stream_pulled = model._stream_pushed_slots = None
        metrics = train_step(self.opt, loss, n, aux)
        if self._gas_push_slots is None:
            self._gas_push_slots = sorted(slots)
        for slot in self._gas_push_slots:
            self.spill_in[slot].async_push(acc[slot][: hb.batch_size],
                                           offset=hb.offset, count=hb.count)
        return metrics

    def train_epoch(self) -> Dict[str, float]:
        # the step loop always, as in the JAX spill trainer: a step stages
        # its rows through the host tables
        out = self._train_epoch_loop(reason="the spill tier trains step by step")
        for t in self.spill_in:
            t.synchronize_push()
        return out

    # ---------------- layer-wise refresh against the host tables ----------------
    @torch.no_grad()
    def _refresh(self, host_logits: bool = True) -> Optional[np.ndarray]:
        """Recompute every layer's cache rows (with VR also ``M_ag``) and the
        logits, layer by layer over the eval batches (mini_inference_vr)."""
        self._steps_since_refresh = 0
        model, cfg = self.model, self.cfg
        L, D = model.cfg.num_layers, model.hist_dim
        batches = self.eval_loader.cached()
        for layer in range(L):
            src = self.spill_in[layer]
            depth = min(src.pool_size - 1, len(batches)) if layer > 0 else 0
            for j in range(depth):  # pulls run ahead of the device
                src.async_pull(batches[j].n_id)
            for i, hb in enumerate(batches):
                beat()
                hb = self.eval_loader.to_device(hb).wait()
                b, bs = hb.device, hb.batch_size
                adj = b.adj
                r_pad = adj.num_rows
                if layer == 0:
                    x_in = self.tables.x.index_select(0, b.n_id).float()
                else:
                    if i + depth < len(batches):
                        src.async_pull(batches[i + depth].n_id)
                    x_in = self._zeros(int(b.n_id.shape[0]), D)
                    src.synchronize_pull(out=x_in[: hb.num_nodes], wait=False)
                    src.free_pull()
                    self._ready(self._copy_event(), x_in)
                    x_in = x_in[:, : model.layer_input_dim(layer)]
                x0_ib = None
                if model.needs_x0 and layer > 0:
                    # layer 0 wrote x0 into M_in[0]'s table
                    x0 = self._zeros(r_pad, D)
                    self._staged_rows(self.spill_in[:1], hb.n_id[:bs], [x0], 0)
                    self._ready(self._copy_event(), x0)
                    x0_ib = x0[:, : model.x0_dim]
                chunks = dict(offset=hb.offset, count=hb.count)
                pre_agg = None
                if layer == 0 and (self.vr or model.needs_x0):
                    m0 = model.layer0_cache_input(x_in)
                    self.spill_in[0].async_push(pad_cols(m0[:bs], D), **chunks)
                    if self.vr:
                        ag = model.vr_cache_value(0, adj, m0)
                        self.spill_ag[0].async_push(pad_cols(ag[:bs], D), **chunks)
                        pre_agg = ag if model.vr_cache_is_agg else None
                elif layer > 0 and self.vr:
                    ag = model.vr_cache_value(layer, adj, x_in)
                    self.spill_ag[layer].async_push(pad_cols(ag[:bs], D), **chunks)
                    pre_agg = ag if model.vr_cache_is_agg else None
                out = model.forward_layer(layer, x_in, x0_ib, adj, cfg.use_aggregation,
                                          pre_agg=pre_agg)
                if layer < L - 1:
                    self.spill_in[layer + 1].async_push(pad_cols(out[:bs], D), **chunks)
                else:
                    valid = valid_rows(r_pad, bs, out.device)
                    push(self.out_table, b.push_idx, torch.where(valid, out[:r_pad], 0.0))
            for t in self.tables_host:
                t.synchronize_push()
        n = self.data.num_nodes
        return self.out_table[:n].cpu().numpy() if host_logits else None

    def fill_history(self) -> np.ndarray:
        return self._refresh()

    # ---------------- checkpoint protocol: the host tables ----------------
    def _cache_state(self) -> Dict[str, torch.Tensor]:
        return {**{f"spill_in.{l}": t.table_t for l, t in enumerate(self.spill_in)},
                **{f"spill_ag.{l}": t.table_t for l, t in enumerate(self.spill_ag)}}
