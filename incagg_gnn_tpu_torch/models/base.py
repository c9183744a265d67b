"""ScalableGNN — the model runtime shared by every model.

Port of ``incagg_gnn_tpu/models/base.py``: the GAS ``push_and_pull``
(reference base.py:380-456), the Reverb/VR pulls and drift metric
(base.py:242-378), and the layer-wise refresh sweep (``mini_inference``,
base.py:509-603).  Caches follow the reference's "index change" convention:
``emb[l]`` = input of layer ``l``; ``emb_ag[l]`` = aggregation of
``emb[l]`` over the full neighborhood.

Models are ``nn.Module``s.  Cache writes and BatchNorm running statistics
update in place; the refresh sweep is a plain loop over layers and batches
(the JAX package's scanned sweep, one program per layer or per sweep, has
no counterpart here).  Over global-column batches (the eval loader's
``global_cols``) the sweep aggregates straight from the cache tables in
their storage dtype (``_refresh_batch_global``), as the JAX package's
default single-device refresh does.

A batch's ``batch_size`` may be a Python int or a 0-dim device tensor (the
fused epoch's static batch, ``train/steps.py::EpochGraph``): the step code
only compares and divides by it, never reads it on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from incagg_gnn_tpu_torch.history import HistoryState, init_history, pull, push
from incagg_gnn_tpu_torch.models.nn import pad_cols, pad_rows
from incagg_gnn_tpu_torch.ops.agg import spmm, spmm_reduce
from incagg_gnn_tpu_torch.ops.ell import spmm_hybrid_table
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
                       out_table: torch.Tensor, batch) -> None:
        """One batch of one refresh layer pass (reference base.py:299-363):
        recompute the layer for the batch's rows and write its caches (and,
        at the last layer, its logits) in place.  Padded rows write zeros
        into the trash row."""
        adj = batch.adj
        r_pad = adj.num_rows
        d = self.hist_dim
        valid = valid_rows(r_pad, batch.batch_size, x_table.device)
        pre_agg = None  # the VR refresh reuses the M_ag aggregation
        if layer == 0:
            x_in = x_table.index_select(0, batch.n_id).float()
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
            x_in = pull(hist.emb[layer], batch.n_id)[:, :dim]
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

    @torch.no_grad()
    def refresh(self, x_table: torch.Tensor, loader, hist: HistoryState,
                out_table: Optional[torch.Tensor] = None, vr: bool = False,
                use_aggregation: bool = True, subset=None,
                host_logits: bool = True) -> Tuple[Optional[np.ndarray], torch.Tensor]:
        """Layer-wise sweep over the eval batches: recompute every layer's
        history (with ``vr`` also the ``M_in``/``M_ag`` caches) and return
        ``(logits on the host or None, out_table)``.  ``subset`` (batch
        indices) refreshes only those batches; the others keep their caches
        and logits.  Layer ``l+1`` reads rows that layer ``l`` wrote for
        other batches, so the loop is layer-major.  A set the loader holds
        on the host is staged anew for each layer, the next batch on a
        thread while the device works on the current one (the JAX
        package's depth-1 prefetch).  Global-column batches (the loader's
        ``uses_global_cols``) take :meth:`_refresh_batch_global`, after
        ``M_in[0]`` is set from the m0 table (wholesale, or per batch for a
        ``subset``); ``_last_refresh_plan`` records the dispatch."""
        n = loader.data.num_nodes
        if out_table is None:
            out_table = torch.zeros((n + 1, self.cfg.out_channels),
                                    device=x_table.device)
        held = loader.cached(subset)
        on_device = all(isinstance(hb.device.n_id, torch.Tensor) for hb in held)
        global_mode = loader.uses_global_cols
        if global_mode:
            assert use_aggregation, ("global-column eval batches need the "
                                     "aggregation; build the eval loader with "
                                     "global_cols=False for no-aggregation runs")
        self._last_refresh_plan = {"global_cols": global_mode, "on_device": on_device,
                                   "n_batches": len(held)}
        push_m0 = subset is not None
        if global_mode:
            m0 = self._m0_table(x_table)
            if not push_m0 and (vr or self.needs_x0):
                hist.emb[0].copy_(m0.to(hist.emb[0].dtype))
        for layer in range(self.cfg.num_layers):
            staged = (contextlib.nullcontext(held) if on_device else
                      contextlib.closing(prefetch(map(loader.to_device, held), depth=1)))
            with staged as batches:
                for hb in batches:
                    beat()
                    if global_mode:
                        self._refresh_batch_global(layer, vr, hist, x_table, out_table,
                                                   hb.wait().device, m0, push_m0)
                    else:
                        self._refresh_batch(layer, vr, use_aggregation, hist, x_table,
                                            out_table, hb.wait().device)
        logits = out_table[:n].cpu().numpy() if host_logits else None
        return logits, out_table
