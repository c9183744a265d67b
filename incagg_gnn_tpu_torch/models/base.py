"""ScalableGNN — the model runtime shared by every model.

Port of ``incagg_gnn_tpu/models/base.py``: the GAS ``push_and_pull``
(reference base.py:380-456), the Reverb/VR pulls and drift metric
(base.py:242-378), and the layer-wise refresh sweep (``mini_inference``,
base.py:509-603).  Caches follow the reference's "index change" convention:
``emb[l]`` = input of layer ``l``; ``emb_ag[l]`` = aggregation of
``emb[l]`` over the full neighborhood.

Models are ``nn.Module``s.  Cache writes and BatchNorm running statistics
update in place.  The refresh sweep (:meth:`ScalableGNN.refresh`) takes one
of three mechanisms, chosen by the JAX package's ``use_scan`` predicate
(base.py:666-670), which the plan ``_last_refresh_plan`` records:

- ``sweep``, the counterpart of ``_refresh_all_scan_fn`` and its global
  form: over a set the eval loader holds on the device, the whole refresh
  (the m0 table, every layer over every batch) captured as one CUDA graph
  over the held batches' own tensors, and each later refresh one replay;
- ``layers``, the counterpart of ``_refresh_layer_scan_fn`` and its global
  form: for a set held on the host, or a ``subset`` (``refresh_frac``), one
  captured batch step per layer over static batch buffers, each batch
  copied in before a replay;
- ``eager``, the plain loop over layers and batches, where the predicate
  fails (``scan=False``, one batch, mixed shapes, a model that overrides
  the per-batch refresh such as PNA_JK).

Over global-column batches (the eval loader's ``global_cols``) every
mechanism aggregates straight from the cache tables in their storage dtype
(``_refresh_batch_global``), as the JAX package's default single-device
refresh does.

A batch's ``batch_size`` may be a Python int or a 0-dim device tensor (the
static batch of a fused epoch or of the ``layers`` refresh,
``train/steps.py::StaticBatch``): the step code
only compares and divides by it, never reads it on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState, init_history, pull, push
from incagg_gnn_tpu_torch.models.nn import pad_cols, pad_rows
from incagg_gnn_tpu_torch.ops.agg import spmm, spmm_reduce
from incagg_gnn_tpu_torch.ops.ell import spmm_hybrid_table
from incagg_gnn_tpu_torch.train.steps import (
    StaticBatch, batch_bytes, batch_shape, capture_graph, replay)
from incagg_gnn_tpu_torch.utils.heartbeat import beat
from incagg_gnn_tpu_torch.utils.prefetch import prefetch


class StreamedPulls(NamedTuple):
    """Pre-staged cache rows of one batch from the host-spill tier: stacked
    ``[num_layers, R_pad, hist_dim]`` M_in and M_ag in f32, aligned with
    the in-batch rows, padded rows zero.  Passed to ``forward_vr`` in place
    of a :class:`HistoryState` when the caches live in host memory
    (``history_spill.SpilledHistory``)."""

    m_in: torch.Tensor
    m_ag: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Shared architecture knobs (reference: conf/model/*.yaml
    ``params.<dataset>.architecture``)."""

    num_nodes: int
    in_channels: int
    hidden_channels: int
    out_channels: int
    num_layers: int
    dropout: float = 0.0


#: bytes of batches a scanned refresh may restage from the host (the JAX
#: package's default; the trainer sets ``_refresh_hbm_budget`` from the
#: card's headroom)
REFRESH_BUDGET = 1_500_000_000


def graphs_on(device: torch.device) -> bool:
    """Whether a scanned refresh on ``device`` is captured as CUDA graphs
    (on the CPU its steps run eagerly)."""
    return device.type == "cuda"


def valid_rows(n: int, batch_size: int, device) -> torch.Tensor:
    """``[n, 1]`` mask of the batch's true in-batch rows."""
    return (torch.arange(n, device=device) < batch_size)[:, None]


class ScalableGNN(nn.Module):
    """Abstract scalable GNN; subclasses implement the per-model forwards
    (``forward_gas``, ``forward_vr``, ``forward_layer``)."""

    #: whether forward_layer needs the initial-residual x0
    needs_x0 = False
    #: feature width of x0 in the ``M_in[0]`` cache (set where needs_x0)
    x0_dim = 0
    #: True when vr_cache_value is the plain neighborhood aggregation, so
    #: the refresh reuses it as forward_layer's pre_agg
    vr_cache_is_agg = True
    #: aggregator of the M_ag caches and the VR correction: "sum" weighs by
    #: the adjacency values (GCN, GCNII, APPNP), "mean" averages over the
    #: binarized adjacency (GraphSAGE)
    vr_reduce = "sum"
    #: the captured refresh programs (made on the first scanned refresh)
    _refresh_graphs: Optional["RefreshGraphs"] = None

    def __init__(self, cfg: BaseConfig):
        super().__init__()
        self.cfg = cfg

    @property
    def hist_dim(self) -> int:
        return self.cfg.hidden_channels

    def layer0_cache_input(self, x: torch.Tensor) -> torch.Tensor:
        """The model-space vector cached as ``M_in[0]``."""
        return x

    def layer_input_dim(self, layer: int) -> int:
        raise NotImplementedError

    def init_history(self, dtype: torch.dtype, device) -> HistoryState:
        return init_history(self.cfg.num_layers, self.cfg.num_nodes,
                            self.hist_dim, dtype, device)

    # ---------------- GAS ----------------
    #: set by the spill tier's GAS step around its forward: the pre-staged
    #: ``[L, C_pad, hist_dim]`` out-of-batch rows that ``push_and_pull``
    #: splices in place of a cache gather; ``hist_emb`` is then a list of
    #: per-batch ``[R_pad, hist_dim]`` accumulators of the pushed rows,
    #: which the trainer writes back to the host tables after the step
    _stream_pulled: Optional[torch.Tensor] = None
    #: the slots the streamed pushes touched (the trainer's write-back set)
    _stream_pushed_slots: Optional[set] = None
    #: set by the sharded trainer around its GAS forward
    #: (``parallel/spatial.py``): the halo exchange ``[slab, D] -> [C_pad,
    #: D]`` of the batch, which pulls the out-of-batch rows from the slabs
    #: of the ranks that own them (JAX ``_shard_halo``)
    _shard_halo = None
    #: the slab's row count, set with ``_shard_halo`` and ``_stream_pulled``
    #: by the sharded spill tier (``parallel/spill_sharded.py``) for its
    #: fresh-push exchange (JAX ``_spill_slab_rows``)
    _spill_slab_rows: Optional[int] = None

    def push_and_pull(self, hist_emb, slot: int, h: torch.Tensor,
                      batch) -> torch.Tensor:
        """Push the in-batch rows of ``h`` into ``hist_emb[slot]`` (in place)
        and splice the pulled out-of-batch rows after them: ``[R_pad, D] ->
        [C_pad, D]`` (reference base.py:380-456)."""
        d = h.shape[1]
        c_pad = batch.n_id.shape[0]
        valid = valid_rows(h.shape[0], batch.batch_size, h.device)
        pushed = torch.where(valid, pad_cols(h.detach(), self.hist_dim), 0.0)
        if self._stream_pulled is not None:
            # spill tier: the pushes accumulate row-aligned (the host writes
            # them back chunk-contiguously) and the pulls were staged
            if self._stream_pushed_slots is not None:
                self._stream_pushed_slots.add(slot)
            hist_emb[slot].copy_(pushed)
            pulled = self._stream_pulled[slot][:, :d].to(h.dtype)
            if self._shard_halo is not None:
                # sharded spill: the staged rows are one round stale where
                # their owner pushed them this round.  Every rank scatters
                # its fresh pushes and a flag column into a slab-shaped
                # buffer, exchanges it over the round's halo and takes the
                # fresh rows where the flag is set: the device path's
                # push-then-exchange lockstep (JAX models/base.py:204-226)
                payload = torch.cat([pushed[:, :d], valid.to(h.dtype)], dim=1).detach()
                src = payload.new_zeros((self._spill_slab_rows, d + 1))
                src.index_copy_(0, batch.push_idx, payload)
                ex = self._shard_halo(src)
                pulled = torch.where(ex[:, d:] != 0, ex[:, :d], pulled)
        elif self._shard_halo is not None:
            # every rank pushes this layer into its own slab before the
            # exchange, which is a collective: the lockstep JAX's shard_map
            # gives (incagg_gnn_tpu/models/base.py:228-233)
            push(hist_emb[slot], batch.push_idx, pushed)
            pulled = self._shard_halo(hist_emb[slot]).detach()[:, :d].to(h.dtype)
        else:
            push(hist_emb[slot], batch.push_idx, pushed)
            pulled = hist_emb[slot].index_select(0, batch.n_id)[:, :d].to(h.dtype)
        ib = valid_rows(c_pad, batch.batch_size, h.device)
        return torch.where(ib, pad_rows(h, c_pad), pulled)

    # ---------------- Reverb/VR ----------------
    def vr_pull(self, hist, layer: int, batch,
                dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The in-batch rows of ``M_in[layer]`` / ``M_ag[layer]``, cropped to
        ``dim`` columns, in f32 (reference base.py:318-323).  ``hist`` is the
        device :class:`HistoryState` (gathered here) or the spill tier's
        :class:`StreamedPulls` (already in-batch aligned)."""
        if isinstance(hist, StreamedPulls):
            return hist.m_in[layer][:, :dim], hist.m_ag[layer][:, :dim]
        m_in = pull(hist.emb[layer], batch.push_idx)[:, :dim]
        m_ag = pull(hist.emb_ag[layer], batch.push_idx)[:, :dim]
        return m_in, m_ag

    def drift_term(self, d: torch.Tensor, batch, drift_norm: int = 2) -> torch.Tensor:
        """Per-layer drift ``Σ_ib ||x − M_in|| / |IB|`` over valid rows."""
        d = torch.where(valid_rows(d.shape[0], batch.batch_size, d.device), d, 0.0)
        num = (d.abs().sum() if drift_norm == 1
               else torch.sqrt((d * d).sum(-1) + 1e-12).sum())
        bs = batch.batch_size
        return num / (bs.clamp(min=1) if isinstance(bs, torch.Tensor) else max(bs, 1))

    def vr_aggregate(self, adj, x: torch.Tensor) -> torch.Tensor:
        """The aggregation of the VR correction and of the ``M_ag`` refresh:
        the weighted sum for normalized adjacencies, the binary mean for
        GraphSAGE (reference graphsage.py:896-898)."""
        if self.vr_reduce == "sum":
            return spmm(adj, x)
        return spmm_reduce(adj.binarized(), x, self.vr_reduce)

    def vr_cache_value(self, layer: int, adj, x: torch.Tensor) -> torch.Tensor:
        """The value written into ``emb_ag[layer]`` by the VR refresh."""
        return self.vr_aggregate(adj, x)

    # ---------------- layer-wise refresh ----------------
    @torch.no_grad()
    def _refresh_batch(self, layer: int, vr: bool, use_aggregation: bool,
                       hist: HistoryState, x_table: torch.Tensor,
                       out_table: torch.Tensor, batch, gather=None) -> None:
        """One batch of one refresh layer pass (reference base.py:299-363):
        recompute the layer for the batch's rows and write its caches (and,
        at the last layer, its logits) in place.  Padded rows write zeros
        into the trash row.  ``gather`` maps a table to the batch's
        ``[C_pad, D]`` input rows (default: its rows ``n_id``; the sharded
        refresh passes its halo exchange)."""
        if gather is None:
            def gather(t):
                return t.index_select(0, batch.n_id)
        adj = batch.adj
        r_pad = adj.num_rows
        d = self.hist_dim
        valid = valid_rows(r_pad, batch.batch_size, x_table.device)
        pre_agg = None  # the VR refresh reuses the M_ag aggregation
        if layer == 0:
            x_in = gather(x_table).float()
            if vr or self.needs_x0:
                m0 = self.layer0_cache_input(x_in)
                push(hist.emb[0], batch.push_idx,
                     torch.where(valid, pad_cols(m0[:r_pad], d), 0.0))
                if vr:
                    ag0 = self.vr_cache_value(0, adj, m0)
                    push(hist.emb_ag[0], batch.push_idx,
                         torch.where(valid, pad_cols(ag0, d), 0.0))
                    pre_agg = ag0 if self.vr_cache_is_agg else None
        else:
            dim = self.layer_input_dim(layer)
            x_in = gather(hist.emb[layer]).float()[:, :dim]
            if vr:
                ag = self.vr_cache_value(layer, adj, x_in)
                push(hist.emb_ag[layer], batch.push_idx,
                     torch.where(valid, pad_cols(ag, d), 0.0))
                pre_agg = ag if self.vr_cache_is_agg else None
        x0_ib = None
        if self.needs_x0 and layer > 0:
            # layer 0 computes x0 inline in forward_layer; later layers read
            # it back from the M_in[0] rows layer 0 wrote
            x0_ib = pull(hist.emb[0], batch.push_idx)[:, :self.x0_dim]
        out = self.forward_layer(layer, x_in, x0_ib, adj, use_aggregation,
                                 pre_agg=pre_agg if use_aggregation else None)
        if layer < self.cfg.num_layers - 1:
            push(hist.emb[layer + 1], batch.push_idx,
                 torch.where(valid, pad_cols(out[:r_pad], d), 0.0))
        else:
            push(out_table, batch.push_idx, torch.where(valid, out[:r_pad], 0.0))

    def _m0_table(self, x_table: torch.Tensor) -> torch.Tensor:
        """``layer0_cache_input`` over the whole feature table in one pass
        (``[N, F] @ [F, D]`` where the model transforms), in f32, padded to
        the cache width, with a zero trash row: ``M_in[0]`` of every node,
        computed once per global-column sweep (JAX ``_m0_table``)."""
        m0 = pad_cols(self.layer0_cache_input(x_table[:-1]).float(), self.hist_dim)
        return torch.cat([m0, m0.new_zeros((1, m0.shape[1]))])

    def global_aggregate(self, adj, table: torch.Tensor) -> torch.Tensor:
        """:meth:`vr_aggregate` over a global-column batch: the columns are
        rows of ``table`` (the m0 table or a cache, in its storage dtype),
        aggregated by kernel B's storage-dtype form; f32 ``[R_pad, D]``."""
        if self.vr_reduce == "sum":
            return spmm_hybrid_table(adj, table)
        # "mean": the binary mean, as vr_aggregate's spmm_reduce takes it
        return spmm_hybrid_table(adj.binarized(), table) / adj.deg.clamp(min=1.0)[:, None]

    @torch.no_grad()
    def _refresh_batch_global(self, layer: int, vr: bool, hist: HistoryState,
                              x_table: torch.Tensor, out_table: torch.Tensor, batch,
                              m0: torch.Tensor, push_m0: bool) -> None:
        """One batch of one refresh layer pass over a global-column batch
        (JAX ``_refresh_batch_step_global``): the layer's aggregation comes
        straight from the ``[N+1, D]`` table (the m0 table at layer 0, else
        ``M_in[layer]`` in its storage dtype), every column at once (a
        cache's columns past the layer's width are zero), and
        ``forward_layer`` gets it as ``pre_agg`` beside the batch's own rows;
        no ``[C_pad, D]`` input is built.  ``M_in[0]`` was written wholesale
        by the caller, or here per batch with ``push_m0`` (a ``subset``
        refresh keeps each cluster's ``(M_in, M_ag)`` pair consistent)."""
        adj = batch.adj
        r_pad = adj.num_rows
        d = self.hist_dim
        valid = valid_rows(r_pad, batch.batch_size, x_table.device)
        ag = self.global_aggregate(adj, m0 if layer == 0 else hist.emb[layer])
        if push_m0 and layer == 0 and (vr or self.needs_x0):
            push(hist.emb[0], batch.push_idx,
                 torch.where(valid, m0.index_select(0, batch.push_idx), 0.0))
        if vr:
            push(hist.emb_ag[layer], batch.push_idx, torch.where(valid, ag, 0.0))
        dim = self.layer_input_dim(layer)
        # the batch's own rows: raw features at layer 0 (forward_layer
        # applies the layer-0 transform itself), else the cached inputs
        if layer == 0:
            x_self = x_table.index_select(0, batch.push_idx).float()
        else:
            x_self = pull(hist.emb[layer], batch.push_idx)[:, :dim]
        x0_ib = None
        if self.needs_x0 and layer > 0:
            x0_ib = pull(hist.emb[0], batch.push_idx)[:, :self.x0_dim]
        out = self.forward_layer(layer, x_self, x0_ib, adj, True, pre_agg=ag[:, :dim])
        if layer < self.cfg.num_layers - 1:
            push(hist.emb[layer + 1], batch.push_idx,
                 torch.where(valid, pad_cols(out[:r_pad], d), 0.0))
        else:
            push(out_table, batch.push_idx, torch.where(valid, out[:r_pad], 0.0))

    # ---------------- the refresh sweep: plan and mechanisms ----------------
    def _refresh_step(self, layer: int, vr: bool, use_aggregation: bool, global_mode: bool,
                      hist: HistoryState, x_table: torch.Tensor, out_table: torch.Tensor,
                      batch, m0: Optional[torch.Tensor], push_m0: bool) -> None:
        """One batch of one refresh layer pass, global-column or batch-local."""
        if global_mode:
            self._refresh_batch_global(layer, vr, hist, x_table, out_table, batch, m0,
                                       push_m0)
        else:
            self._refresh_batch(layer, vr, use_aggregation, hist, x_table, out_table, batch)

    def _m0_set(self, x_table: torch.Tensor, hist: HistoryState, vr: bool,
                wholesale: bool) -> torch.Tensor:
        """The m0 table, and ``M_in[0]`` set from it wholesale where the
        sweep needs it (JAX ``_m0_set_fn``)."""
        m0 = self._m0_table(x_table)
        if wholesale and (vr or self.needs_x0):
            hist.emb[0].copy_(m0.to(hist.emb[0].dtype))
        return m0

    def drop_refresh_graphs(self) -> None:
        """Drop the captured refresh graphs; the next refresh of a key
        already warmed up captures anew."""
        if self._refresh_graphs is not None:
            self._refresh_graphs.sweep = self._refresh_graphs.layers = None

    def _graphs(self) -> "RefreshGraphs":
        if self._refresh_graphs is None:
            self._refresh_graphs = RefreshGraphs()
        return self._refresh_graphs

    def _graph_key(self, mechanism: str, loader, batches, flags: tuple,
                   tensors: List[torch.Tensor]) -> tuple:
        """What a captured refresh depends on: the mechanism, the loader and
        ``batches`` (its held set, or the batch shape), the sweep's flags,
        where each tensor it reads or writes lies, and the model's class."""
        return (mechanism, id(loader), batches, flags, type(self),
                tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors))

    def _refresh_eager(self, held, on_device: bool, loader, vr: bool, use_aggregation: bool,
                       global_mode: bool, push_m0: bool, hist: HistoryState,
                       x_table: torch.Tensor, out_table: torch.Tensor) -> Dict:
        """The plain loop, layer-major over the batches; a set held on the
        host is staged anew for each layer, the next batch on a thread while
        the device works on the current one (the JAX package's depth-1
        prefetch)."""
        m0 = self._m0_set(x_table, hist, vr, not push_m0) if global_mode else None
        for layer in range(self.cfg.num_layers):
            staged = (contextlib.nullcontext(held) if on_device else
                      contextlib.closing(prefetch(map(loader.to_device, held), depth=1)))
            with staged as batches:
                for hb in batches:
                    beat()
                    self._refresh_step(layer, vr, use_aggregation, global_mode, hist,
                                       x_table, out_table, hb.wait().device, m0, push_m0)
        return {"warmup": False, "launches_per_replay": {}}

    def _refresh_sweep(self, held, loader, vr: bool, use_aggregation: bool, global_mode: bool,
                       hist: HistoryState, x_table: torch.Tensor,
                       out_table: torch.Tensor, tensors: List[torch.Tensor]) -> Dict:
        """The whole refresh over the held batches' own tensors (JAX
        ``_refresh_all_scan_fn`` and its global form): on CUDA one eager
        warm-up run for a new key, then one capture and a replay for every
        refresh; on the CPU the same function eagerly."""
        batches = [hb.wait().device for hb in held]

        def sweep():
            m0 = self._m0_set(x_table, hist, vr, True) if global_mode else None
            for layer in range(self.cfg.num_layers):
                for batch in batches:
                    self._refresh_step(layer, vr, use_aggregation, global_mode, hist,
                                       x_table, out_table, batch, m0, False)

        if not graphs_on(x_table.device):
            sweep()
            beat()
            return {"warmup": False, "launches_per_replay": {}}
        graphs = self._graphs()
        key = self._graph_key("sweep", loader, id(held), (vr, use_aggregation, global_mode),
                              tensors)
        if graphs.sweep is not None and graphs.sweep.key != key:
            graphs.sweep = None
        if key not in graphs.warmed:
            sweep()
            beat()
            graphs.warmed.add(key)
            return {"warmup": True, "launches_per_replay": {}}
        if graphs.sweep is None:
            graph, per = capture_graph(sweep, pool=graphs.pool_handle(),
                                       keep_graph=graphs.keep_graph)
            # the graph reads and writes these by address: keep them alive
            graphs.sweep = _SweepGraph(key, [held, *tensors], graph, per)
            graphs.captures += 1
        replay(graphs.sweep.graph, graphs.sweep.launches_per_replay)
        beat()
        return {"warmup": False, "launches_per_replay": dict(graphs.sweep.launches_per_replay)}

    def _refresh_layers(self, held, on_device: bool, loader, vr: bool, use_aggregation: bool,
                        global_mode: bool, push_m0: bool, hist: HistoryState,
                        x_table: torch.Tensor, out_table: torch.Tensor,
                        tensors: List[torch.Tensor]) -> Dict:
        """One batch step per layer over static batch buffers (JAX
        ``_refresh_layer_scan_fn`` and its global form, after
        ``_m0_set_fn``): each batch is copied into the buffers (a staged one
        after its copies, a held one device to device), then the layer's
        step runs on them.  On CUDA each layer's step is captured once per
        key after one eager warm-up refresh, and replayed for every batch
        of every later refresh, whatever its ``subset``; on the CPU the
        same steps run eagerly on the buffers."""
        captured = graphs_on(x_table.device)
        graphs = self._graphs()
        key = self._graph_key("layers", loader, batch_shape(held[0].device),
                              (vr, use_aggregation, global_mode, push_m0), tensors)
        if graphs.layers is None or graphs.layers.key != key:
            graphs.layers = _LayerGraphs(key, tensors, self.cfg.num_layers)
        st = graphs.layers
        warmup = captured and key not in graphs.warmed
        if global_mode:
            m0 = self._m0_set(x_table, hist, vr, not push_m0)
            if st.m0 is None:
                st.m0 = m0  # the address the captured steps read
            else:
                st.m0.copy_(m0)

        def step(layer):
            self._refresh_step(layer, vr, use_aggregation, global_mode, hist, x_table,
                               out_table, st.static.batch, st.m0, push_m0)

        for layer in range(self.cfg.num_layers):
            staged = (contextlib.nullcontext(held) if on_device else
                      contextlib.closing(prefetch(map(loader.to_device, held), depth=1)))
            with staged as batches:
                for hb in batches:
                    beat()
                    batch = hb.wait().device
                    if st.static is None:
                        st.static = StaticBatch(batch)
                    else:
                        st.static.load(batch)
                    if not captured or warmup:
                        step(layer)
                        continue
                    if st.graphs[layer] is None:
                        st.graphs[layer], st.launches[layer] = capture_graph(
                            lambda layer=layer: step(layer), pool=graphs.pool_handle(),
                            keep_graph=graphs.keep_graph)
                        graphs.captures += 1
                    replay(st.graphs[layer], st.launches[layer])
        if warmup:
            graphs.warmed.add(key)
        return {"warmup": warmup, "launches_per_replay": [dict(p) for p in st.launches]}

    @torch.no_grad()
    def refresh(self, x_table: torch.Tensor, loader, hist: HistoryState,
                out_table: Optional[torch.Tensor] = None, vr: bool = False,
                use_aggregation: bool = True, scan: bool = True, subset=None,
                host_logits: bool = True) -> Tuple[Optional[np.ndarray], torch.Tensor]:
        """Layer-wise sweep over the eval batches: recompute every layer's
        history (with ``vr`` also the ``M_in``/``M_ag`` caches) and return
        ``(logits on the host or None, out_table)``.  ``subset`` (batch
        indices) refreshes only those batches; the others keep their caches
        and logits.  Layer ``l+1`` reads rows that layer ``l`` wrote for
        other batches, so every mechanism is layer-major.

        The mechanism follows the JAX package's predicate (base.py:666-670):
        with ``scan``, batches of one shape, more than one of them, the set
        held on the device, or its bytes within ``_refresh_hbm_budget``, or
        at most 64 batches, and no override of the per-batch refresh, the
        refresh is scanned: ``sweep`` (one captured graph over the held
        set) when the loader holds the set on the device and there is no
        ``subset``, else ``layers`` (a captured step per layer over static
        buffers); otherwise the ``eager`` loop.  On CUDA the first refresh
        of a graph key runs eagerly (``warmup`` in the plan), the next
        captures and every later one replays; a failed capture or replay
        raises.  Global-column batches (the loader's ``uses_global_cols``)
        take :meth:`_refresh_batch_global`, after ``M_in[0]`` is set from
        the m0 table (wholesale, or per batch for a ``subset``).
        ``_last_refresh_plan`` records the predicate's inputs (the JAX
        plan's keys; ``resident``: the loader holds the set on the device),
        the ``mechanism``, the model's refresh ``captures`` so far and what
        a replay launches."""
        n = loader.data.num_nodes
        if out_table is None:
            out_table = torch.zeros((n + 1, self.cfg.out_channels),
                                    device=x_table.device)
        held = loader.cached(subset)
        on_device = all(isinstance(hb.device.n_id, torch.Tensor) for hb in held)
        shape = batch_shape(held[0].device)
        homogeneous = all(batch_shape(hb.device) == shape for hb in held[1:])
        per_batch = batch_bytes(held[0].device)
        budget = getattr(self, "_refresh_hbm_budget", REFRESH_BUDGET)
        use_scan = (scan and homogeneous and len(held) > 1
                    and (on_device or per_batch * len(held) <= budget or len(held) <= 64)
                    and type(self)._refresh_batch is ScalableGNN._refresh_batch)
        global_mode = loader.uses_global_cols
        if global_mode:
            assert use_aggregation, ("global-column eval batches need the "
                                     "aggregation; build the eval loader with "
                                     "global_cols=False for no-aggregation runs")
        push_m0 = subset is not None
        mechanism = ("eager" if not use_scan
                     else "sweep" if on_device and subset is None else "layers")
        tensors = [x_table, out_table, *hist.emb, *hist.emb_ag, *self.parameters(),
                   *self.buffers()]
        if mechanism == "sweep":
            ran = self._refresh_sweep(held, loader, vr, use_aggregation, global_mode, hist,
                                      x_table, out_table, tensors)
        elif mechanism == "layers":
            ran = self._refresh_layers(held, on_device, loader, vr, use_aggregation,
                                       global_mode, push_m0, hist, x_table, out_table,
                                       tensors)
        else:
            ran = self._refresh_eager(held, on_device, loader, vr, use_aggregation,
                                      global_mode, push_m0, hist, x_table, out_table)
        self._last_refresh_plan = {
            "use_scan": use_scan, "on_device": on_device, "homogeneous": homogeneous,
            "n_batches": len(held), "per_batch_mb": round(per_batch / 1e6, 2),
            "budget_mb": round(budget / 1e6, 1), "global_cols": global_mode,
            "resident": on_device, "mechanism": mechanism,
            "captures": 0 if self._refresh_graphs is None else self._refresh_graphs.captures,
            **ran}
        logits = out_table[:n].cpu().numpy() if host_logits else None
        return logits, out_table


@dataclasses.dataclass
class _SweepGraph:
    """The captured sweep: its key, the tensors it reads and writes by
    address (kept alive with it), the graph and what a replay launches."""

    key: tuple
    refs: list
    graph: object
    launches_per_replay: Dict[str, int]


class _LayerGraphs:
    """The ``layers`` mechanism's state for one key: the static batch, the
    m0 table's buffer, and each layer's captured step with what one replay
    launches."""

    def __init__(self, key: tuple, refs: list, num_layers: int):
        self.key, self.refs = key, refs
        self.static: Optional[StaticBatch] = None
        self.m0: Optional[torch.Tensor] = None
        self.graphs: list = [None] * num_layers
        self.launches: List[Dict[str, int]] = [{} for _ in range(num_layers)]


class RefreshGraphs:
    """A model's captured refresh programs: the ``sweep`` graph and the
    ``layers`` graphs, one slot each (a new key drops the slot's graphs),
    in one memory pool (they are replayed one at a time); the keys that
    have had their eager warm-up refresh; and the captures made so far.
    With ``keep_graph`` set (on the class, before a capture) each captured
    ``cudaGraph_t`` is kept, so that a check can read its nodes."""

    keep_graph = False

    def __init__(self):
        self.sweep: Optional[_SweepGraph] = None
        self.layers: Optional[_LayerGraphs] = None
        self.warmed: set = set()
        self.captures = 0
        self._pool = None

    def pool_handle(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool
