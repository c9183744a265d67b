"""Training loop (port of ``incagg_gnn_tpu/train/trainer.py``; reference
main.py:112-264): partition → permute → normalize → loaders →
model/optimizer → history fill → epoch loop (train steps + layer-wise
refresh + eval), on one explicit device, or with ``mesh`` as one program
on every rank of a mesh over row-sharded caches and tables
(``parallel/rows.py``); and :func:`full_graph_forward`, the inductive
eval's whole-graph forward on another graph."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from incagg_gnn_tpu_torch.graph.csr import GraphData, gcn_norm, permute
from incagg_gnn_tpu_torch.graph.partition import partition_graph
from incagg_gnn_tpu_torch.history import (
    HistoryState, fill, init_history, local_rows, resolve_dtype)
from incagg_gnn_tpu_torch.loader import (
    EvalSubgraphLoader, PadBuckets, SubgraphLoader, _tensors)
from incagg_gnn_tpu_torch.models.base import ScalableGNN
from incagg_gnn_tpu_torch.ops.block import BF16
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel import rows as R
from incagg_gnn_tpu_torch.parallel.mesh import Mesh
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import (
    batch_shape, gas_loss, make_gas_epoch_graph, make_vr_epoch_graph, train_step,
    vr_loss)
from incagg_gnn_tpu_torch.train.tables import make_tables
from incagg_gnn_tpu_torch.utils.heartbeat import beat
from incagg_gnn_tpu_torch.utils.logging import MetricsLogger
from incagg_gnn_tpu_torch.utils.metrics import compute_micro_f1, split_metrics_device
from incagg_gnn_tpu_torch.utils.prefetch import prefetch
from incagg_gnn_tpu_torch.utils.watchdog import Watchdog

_LATER = "is a later step of the PyTorch port (ROADMAP.md)"
#: training batches collated and staged ahead of the step (the JAX loop's)
PREFETCH_DEPTH = 2
#: bytes of an epoch's batches the fused epoch may hold on the device at
#: once, unless the card's headroom gives more (the JAX trainer's default)
FUSED_BUDGET = 1_500_000_000


@dataclasses.dataclass
class TrainerConfig:
    """Trainer knobs, the same fields as the JAX package's TrainerConfig
    (reference: conf/model/*.yaml params + CLI overrides).  Values whose
    feature the port does not have yet raise at ``Trainer`` construction."""

    num_parts: int = 8
    partition_method: str = "greedy"  # or "multilevel"
    batch_size: int = 1  # clusters per training batch
    vr_update: bool = False  # False = GAS, True = Reverb/VR
    num_neighbors: int = -1  # per-row sampling cap of GAS batches (ns); -1 off
    max_steps: int = -1  # abort epoch after N steps (staleness knob)
    lr: float = 0.01
    reg_weight_decay: float = 0.0
    nonreg_weight_decay: float = 0.0
    grad_norm: Optional[float] = None
    edge_dropout: float = 0.0  # DropEdge rate (trains on the COO format)
    epochs: int = 100
    seed: int = 42
    loop: bool = True  # add self-loops
    norm: bool = True  # gcn-normalize
    aggregate_combined: bool = True  # False = IB-only ablation (GAS)
    use_aggregation: bool = True
    drift_norm: int = 2
    log_every: int = 1
    eval_batch_size: int = 1  # clusters per eval batch
    hist_dtype: str = "float32"  # cache dtype (bfloat16 also selects bf16 tiles)
    x_dtype: str = "float32"  # or "bfloat16" feature table
    metrics_path: Optional[str] = None  # JSONL sink of train_epoch/eval records
    period_updates_in_one_epoch: int = 0  # extra refreshes inside an epoch
    refresh_drift_threshold: float = 0.0  # refresh when step drift exceeds it
    hist_momentum: float = 0.0  # EMA blend of refreshed caches
    refresh_frac: float = 1.0  # partial refresh window, rotating
    adj_format: str = "auto"  # "auto" | "block" | "hybrid" | "coo"
    #: the epoch as replays of one captured step (CUDA graph): "auto" when
    #: every batch has one shape and the JAX predicate holds, "on" also past
    #: 64 batches that are not device-resident, "off" the step loop
    fused_epoch: str = "auto"
    static_groups: bool = False  # fixed cluster->batch grouping
    #: the sharded trainer's halo wire (``parallel/spatial.py``): "auto"
    #: (ragged on NCCL, dense on gloo), "dense" or "ragged"
    halo_wire: str = "auto"
    #: fail-fast deadline on each train step's device work
    #: (``utils/watchdog.py``): raises DeviceTimeoutError; 0 disables
    device_timeout_s: float = 0.0


#: the models whose aggregations (weighted sum, mean) the dense tier serves
#: (the JAX trainer's ``blockable`` list)
_BLOCKABLE = ("GCN", "GCN2", "APPNP", "GraphSAGE")
#: the models ported so far: GAT's attention and PNA's max/min aggregators
#: train on hybrid or COO
_MODELS = _BLOCKABLE + ("GAT", "PNA", "PNA_JK")


def _check_supported(model: ScalableGNN, cfg: TrainerConfig) -> None:
    if model.__class__.__name__ not in _MODELS:
        raise NotImplementedError(f"model {model.__class__.__name__} {_LATER}")
    if cfg.fused_epoch not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused_epoch {cfg.fused_epoch!r}")
    if cfg.adj_format not in ("auto", "block", "hybrid", "coo"):
        raise ValueError(f"unknown adj_format {cfg.adj_format!r}")


def choose_formats(model: ScalableGNN, cfg: TrainerConfig, sharded: bool = False):
    """The (training, eval) loader formats (JAX trainer.py:149-199).
    ``auto``: COO for edge dropout (value-level masking), else the dense
    tier for the blockable models, whose own cost model and device budget
    still gate it per graph, else hybrid (GAT).  The IB-only ablation
    (``aggregate_combined=false``) keeps to the slot-exact hybrid and COO
    formats: a dense cell sums duplicate edges, so its masked degree would
    undercount them.  Under a mesh (``sharded``) no model is blockable, as
    in JAX (the tier's custom call does not shard-propagate there)."""
    needs_coo = cfg.edge_dropout > 0.0
    blockable = (model.__class__.__name__ in _BLOCKABLE
                 and cfg.aggregate_combined and not sharded)
    if cfg.adj_format == "auto":
        train_fmt = "coo" if needs_coo else ("block" if blockable else "hybrid")
        return train_fmt, "block-fwd" if blockable else "hybrid-fwd"
    if cfg.adj_format == "block":
        if needs_coo:
            raise ValueError("adj_format=block is incompatible with edge_dropout"
                             " (value-level masking needs COO)")
        if not blockable:
            raise ValueError(f"adj_format=block unsupported here: model "
                             f"{model.__class__.__name__} must use sum/mean "
                             f"aggregation (GCN/GCN2/APPNP/GraphSAGE) with "
                             f"aggregate_combined=True, and the trainer must not "
                             f"run under a GSPMD mesh")
        return "block", "block-fwd"
    if cfg.adj_format == "hybrid":
        if needs_coo:
            raise ValueError("adj_format=hybrid is incompatible with "
                             "edge_dropout (value-level masking needs COO)")
        return "hybrid", "hybrid-fwd"
    return "coo", "coo"


class Trainer:
    """Single-stream trainer (one batch at a time, or with ``fused_epoch``
    the whole epoch as replays of one captured step).

    With ``mesh`` (this rank's place in a mesh, ``parallel/mesh.py``), the
    counterpart of JAX ``Trainer(mesh=...)``: every rank runs this same
    program on the same batches, and the history caches, node tables and
    logits table are sharded by rows over the mesh's first axis
    (``parallel/rows.py``): the rows are padded to ``rows_pad``, a multiple
    of the ranks, and each rank holds its host's ``rows_pad / n_hosts``
    rows of each (``rows_pad / n`` on a 1-D mesh; a ``(hosts x chips)``
    mesh's chips of one host hold the same slab).  Pulls gather across the
    slabs with one all-reduce, pushes write the host's own rows, and rank
    0's gradient is applied on every rank
    (``rows.MeshOptimizer``).  No dense tier, ``adj_format=block`` refused
    and no global-column refresh, as in JAX.  Under NCCL the fused epoch
    and the captured refresh hold the collectives; under gloo the epoch
    loops and the refresh runs eagerly, and their records say why."""

    #: whether the eval loader may collate global columns (the spill tier
    #: refreshes batch-locally from its host tables)
    global_refresh = True

    def __init__(self, model: ScalableGNN, data: GraphData, cfg: TrainerConfig,
                 device, log: bool = False, mesh: Optional[Mesh] = None):
        _check_supported(model, cfg)
        if mesh is not None:
            R.check_mesh(mesh, device)
        self.cfg = cfg
        self.device = torch.device(device)
        self.log = log
        self.mesh = mesh
        #: why the epoch and the refresh cannot be captured here ("" where
        #: they can: one device, or a mesh over NCCL)
        self._capture_reason = M.capture_reason(mesh)
        t = time.perf_counter()

        # --- partition & permute (main.py:144-145) ---
        perm, ptr = partition_graph(data.adj_t, cfg.num_parts, seed=cfg.seed,
                                    method=cfg.partition_method)
        data = permute(data, perm)
        self.perm, self.ptr = perm, ptr

        # --- graph transforms (main.py:147-151) ---
        if cfg.loop:
            data.adj_t = data.adj_t.set_diag()
        if cfg.norm:
            data.adj_t = gcn_norm(data.adj_t, add_self_loops=False)
        self.data = data
        self.weighted_adj = data.adj_t.value is not None
        self.multilabel = data.multilabel

        # --- loaders (main.py:158-164) ---
        train_mode = "ib" if cfg.vr_update else (
            "ns" if cfg.num_neighbors >= 0 else "gas")
        train_fmt, eval_fmt = choose_formats(model, cfg, sharded=mesh is not None)
        self.blk_kwargs = blk_kwargs = dict(
            block_dtype=BF16 if cfg.hist_dtype == "bfloat16" else np.float32,
            block_d_hint=int(model.cfg.hidden_channels),
            block_force=cfg.adj_format == "block",
        )
        self.train_loader = SubgraphLoader(
            data, ptr, self.device, batch_size=cfg.batch_size, mode=train_mode,
            num_neighbors=cfg.num_neighbors, shuffle=True, seed=cfg.seed,
            adj_format=train_fmt, static_groups=cfg.static_groups,
            adj_perm=model.__class__.__name__ == "GAT" and train_fmt == "hybrid",
            **(blk_kwargs if train_fmt == "block" else {}))
        self.train_loader.in_flight = PREFETCH_DEPTH
        # global-column eval collate (JAX trainer.py:224-238): the refresh
        # aggregates straight from the [N+1, D] cache tables; the sum/mean
        # family only (forward_layer takes pre_agg)
        blockable = (model.__class__.__name__ in _BLOCKABLE and cfg.aggregate_combined)
        global_ok = (blockable and cfg.use_aggregation and self.global_refresh
                     and mesh is None and eval_fmt in ("hybrid-fwd", "block-fwd"))
        self.eval_loader = EvalSubgraphLoader(
            data, ptr, self.device, batch_size=cfg.eval_batch_size,
            adj_format=eval_fmt, global_cols=global_ok,
            **(blk_kwargs if eval_fmt == "block-fwd" else {}))

        # --- model / optimizer / history ---
        self.model = model.to(self.device)
        opt_args = (model, model.reg_mask(), cfg.lr, cfg.reg_weight_decay,
                    cfg.nonreg_weight_decay, cfg.grad_norm)
        if mesh is None:
            self.opt = Optimizer(*opt_args)
        else:
            M.broadcast_module(mesh, model)
            self.opt = R.MeshOptimizer(mesh, *opt_args)
        # one program draws one mask: the same seed on every rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.hist = self._make_caches()
        x_dtype = resolve_dtype(cfg.x_dtype)
        out_c = model.cfg.out_channels
        if mesh is None:
            self.tables = make_tables(data, self.device, dtype=x_dtype)
            self.out_table = torch.zeros((data.num_nodes + 1, out_c), device=self.device)
        else:
            self.tables = R.shard_tables(data, mesh, x_dtype)
            self.out_table = R.RowSharded.zeros(mesh, data.num_nodes + 1, (out_c,),
                                                torch.float32)
        self._fused_budget = FUSED_BUDGET
        if self.device.type == "cuda":
            # device-cache budgets from the card's memory left after the
            # caches and tables, split between the two loaders
            _, total = torch.cuda.mem_get_info(self.device)
            caches = () if self.hist is None else (*self.hist.emb, *self.hist.emb_ag)
            used = sum(t.numel() * t.element_size() for t in (
                *caches, *self.tables, self.out_table))
            headroom = max(int(total * 0.85) - used, 400_000_000)
            if cfg.batch_size == 1 or cfg.static_groups:
                self.eval_loader.hbm_budget = int(headroom * 0.6)
                self.train_loader.hbm_budget = int(headroom * 0.4)
            else:
                self.eval_loader.hbm_budget = headroom
            # the fused epoch's batches coexist with the batch caches
            self._fused_budget = max(FUSED_BUDGET, int(headroom * 0.25))
        # the scanned refresh's host-restaging gate shares that budget (JAX
        # trainer.py:305-307)
        model._refresh_hbm_budget = self._fused_budget

        self._train_mask_host = np.concatenate([data.train_mask, [False]])
        self.max_steps = (cfg.max_steps if cfg.max_steps != -1
                          else max(1, cfg.num_parts // cfg.batch_size))
        self._steps_since_refresh = 0
        self._refresh_cursor = 0
        self.metrics = MetricsLogger(cfg.metrics_path)
        self.watchdog = Watchdog(cfg.device_timeout_s)
        self._fused_fn = None  # the epoch graph, made on the first fused epoch
        #: how the last epoch trained: ``fused``, the predicate's ``reason``
        #: when it did not, the batches, and the graph's captures and
        #: launches per replay
        self._last_fused_plan: Dict = {}
        self.epoch = 0  # the next epoch to run (set by a checkpoint restore)
        self.restored_meta: Optional[dict] = None
        self._last_eval_s: Optional[float] = None
        if log:
            print(f"Trainer ready [{time.perf_counter() - t:.2f}s]")

    def _make_caches(self) -> Optional[HistoryState]:
        """The history caches on the device (none for the spill tier), by
        rows under a mesh."""
        dtype = resolve_dtype(self.cfg.hist_dtype)
        if self.mesh is None:
            return self.model.init_history(dtype, self.device)
        m = self.model
        return R.shard_history(self.mesh, m.cfg.num_layers, m.cfg.num_nodes, m.hist_dim,
                               dtype)

    @property
    def writes_checkpoint(self) -> bool:
        """Whether this process writes the checkpoint file (under a mesh,
        rank 0; every rank gathers the state)."""
        return self.mesh is None or self.mesh.rank == 0

    def checkpoint_written(self) -> None:
        """After a checkpoint's write: under a mesh, every rank waits for
        rank 0's file."""
        if self.mesh is not None:
            M.barrier(self.mesh)

    # ---------------- phases ----------------
    def _refresh(self, host_logits: bool = True) -> Optional[np.ndarray]:
        """Layer-wise cache refresh, optionally EMA-blended
        (``hist_momentum``) and optionally partial (``refresh_frac``: a
        rotating window of eval batches)."""
        self._steps_since_refresh = 0
        mom = self.cfg.hist_momentum
        old = None
        caches = [local_rows(t) for t in (*self.hist.emb, *self.hist.emb_ag)]
        if 0.0 < mom < 1.0:
            old = [t.clone() for t in caches]
        subset = None
        frac = self.cfg.refresh_frac
        nb = len(self.eval_loader)
        if 0.0 < frac < 1.0 and nb > 1:
            w = max(1, int(np.ceil(nb * frac)))
            cur = self._refresh_cursor
            subset = [(cur + j) % nb for j in range(w)]
            self._refresh_cursor = (cur + w) % nb
        logits = self._sweep(subset, host_logits)
        if old is not None:
            with torch.no_grad():
                for o, n in zip(old, caches):
                    n.copy_(((1.0 - mom) * o.float() + mom * n.float()).to(n.dtype))
        return logits

    def _sweep(self, subset=None, host_logits: bool = True) -> Optional[np.ndarray]:
        """The model's layer-wise refresh of the caches and logits table;
        the ``[N, C]`` logits on the host with ``host_logits`` (under a
        mesh, the slabs gathered on every rank).  Where the refresh cannot
        be captured (a mesh over gloo) it runs eagerly, and
        ``_last_refresh_plan`` says why."""
        model, reason = self.model, self._capture_reason
        logits, self.out_table = model.refresh(
            self.tables.x, self.eval_loader, self.hist, self.out_table,
            vr=self.cfg.vr_update, use_aggregation=self.cfg.use_aggregation,
            scan=not reason, subset=subset, host_logits=host_logits and self.mesh is None)
        model._last_refresh_plan["reason"] = reason
        if host_logits and self.mesh is not None:
            logits = self.out_table.to_host()[:self.data.num_nodes].numpy()
        return logits

    def fill_history(self) -> np.ndarray:
        """Initial cache fill via the layer-wise sweep (main.py:210-215);
        returns the full-graph logits (permuted node order)."""
        return self._sweep()

    def _train_batches(self):
        """``(batch, staged)`` pairs of one epoch, collated and staged on a
        thread ahead of the step; ``staged`` is what a trainer stages beside
        the batch (nothing here)."""
        return prefetch(((hb, None) for hb in self.train_loader), PREFETCH_DEPTH)

    def step(self, hb, staged=None) -> Dict:
        """One training step on a loader batch."""
        cfg = self.cfg
        drop = dict(edge_dropout_p=cfg.edge_dropout, weighted_adj=self.weighted_adj)
        if cfg.vr_update:
            loss, n, aux = vr_loss(self.model, hb.device, self.tables, self.hist,
                                   self.generator, self.multilabel,
                                   cfg.drift_norm, **drop)
        else:
            loss, n, aux = gas_loss(self.model, hb.device, self.tables,
                                    self.hist.emb, self.generator,
                                    self.multilabel, cfg.use_aggregation,
                                    cfg.aggregate_combined, **drop)
        return train_step(self.opt, loss, n, aux)

    def _fused_epoch_ok(self, batches: List, n: int) -> str:
        """Why the epoch cannot run fused, or ``""`` when it can: the JAX
        trainer's predicate (trainer.py:436-472) condition for condition,
        over ``batches``, the first of the epoch's ``n`` (a prefix that
        fails makes the epoch fail)."""
        cfg = self.cfg
        if cfg.fused_epoch == "off":
            return "fused_epoch=off"
        if self._capture_reason:
            return self._capture_reason
        if (cfg.period_updates_in_one_epoch > 0 or cfg.edge_dropout > 0.0
                or cfg.refresh_drift_threshold > 0.0
                or 0 < cfg.max_steps < n or n < 2):
            return ("mid-epoch refresh, edge dropout, max_steps or fewer than "
                    "2 batches")
        if not cfg.vr_update and cfg.num_neighbors >= 0:
            return "neighbor sampling re-draws every epoch"
        if not batches:
            return ""
        # past 64 shuffled batches restaging outweighs the dispatch saved,
        # unless the single-cluster set is held on the device
        device_resident = ((cfg.batch_size == 1 or cfg.static_groups)
                           and self.train_loader._use_device_cache())
        if cfg.fused_epoch == "auto" and n > 64 and not device_resident:
            return "over 64 batches, not device-resident"
        first = batches[0].device
        if any(batch_shape(hb.device) != batch_shape(first) for hb in batches[1:]):
            return "a pad bucket grew: the batches differ in shape"
        per = sum(t.numel() * t.element_size() for t in _tensors(first))
        if per * n >= self._fused_budget:
            return f"{per * n} bytes of batches over the {self._fused_budget} budget"
        return ""

    def _train_epoch_fused(self, batches) -> Dict:
        """The epoch as replays of one captured step (``EpochGraph``): one
        watchdog wait and one host read.  Batches with no train row are
        dropped here, as the JAX scan's ``where(keep)`` leaves all state."""
        cfg = self.cfg
        if self._fused_fn is None:
            if cfg.vr_update:
                self._fused_fn = make_vr_epoch_graph(
                    self.model, self.opt, self.tables, self.hist, self.generator,
                    self.multilabel, cfg.drift_norm)
            else:
                self._fused_fn = make_gas_epoch_graph(
                    self.model, self.opt, self.tables, self.hist.emb, self.generator,
                    self.multilabel, cfg.aggregate_combined, cfg.use_aggregation)
        kept = [hb for hb in batches
                if self._train_mask_host[hb.n_id[: hb.batch_size]].any()]
        t0 = time.perf_counter()
        loss = 0.0
        if kept:
            loss, _ = self._fused_fn([hb.wait().device for hb in kept])
            if cfg.device_timeout_s > 0:
                loss = self.watchdog.wait(loss, "fused epoch")
            loss = float(loss)
        beat()
        dt = time.perf_counter() - t0
        self._steps_since_refresh += len(batches)
        self._last_fused_plan = {
            "fused": True, "reason": "", "batches": len(batches),
            "captures": self._fused_fn.captures,
            "launches_per_replay": dict(self._fused_fn.launches_per_replay)}
        out = {"loss": loss, "steps": len(batches), "drift": 0.0, "epoch_s": dt,
               "edges_per_s": sum(hb.num_edges for hb in batches) / max(dt, 1e-9),
               "staleness_steps": self._steps_since_refresh, **self._last_fused_plan}
        self.metrics.log("train_epoch", **out)
        return out

    def train_epoch(self) -> Dict:
        """One training epoch (mini_train, main.py:47-96): fused where
        :meth:`_fused_epoch_ok` allows (JAX trainer.py:528-535), else the
        step loop.  The batches are collected while the predicate holds, so
        an epoch that cannot fuse holds no more of them than it must.  They
        are collated and staged on the prefetch thread, as the loop's are
        (the JAX trainer collects them with ``list(loader)``): an epoch
        that cannot fuse goes on with the same pass, the thread ahead of it."""
        n = len(self.train_loader)
        reason = self._fused_epoch_ok([], n)
        if reason:
            return self._train_epoch_loop(reason=reason)
        batches = []
        with contextlib.closing(self._train_batches()) as source:
            for hb, _ in source:
                batches.append(hb)
                reason = self._fused_epoch_ok(batches, n)
                if reason:
                    begun = itertools.chain(((b, None) for b in batches), source)
                    return self._train_epoch_loop((p for p in begun), reason)
        return self._train_epoch_fused(batches)

    def _train_epoch_loop(self, begun=None, reason: str = "") -> Dict:
        """The step loop over the loader's batches (or ``begun``, the
        ``(batch, staged)`` pairs of a pass already begun, which its caller
        closes); ``reason``: why not fused."""
        self._last_fused_plan = {"fused": False, "reason": reason,
                                 "batches": len(self.train_loader), "captures": 0,
                                 "launches_per_replay": {}}
        total_loss = total_n = total_drift = 0.0
        total_edges = steps = drift_refreshes = 0
        t0 = time.perf_counter()
        period = 0
        if self.cfg.period_updates_in_one_epoch > 0:
            eff = min(len(self.train_loader), self.max_steps)
            period = max(1, eff // self.cfg.period_updates_in_one_epoch)
        # the next batches are collated and staged on a thread while the
        # device runs a step; leaving the block stops and joins the thread
        source = self._train_batches() if begun is None else begun
        with contextlib.closing(source) as batches:
            for hb, staged in batches:
                hb.wait()
                beat()
                if period and steps > 0 and steps % period == 0:
                    self._refresh()
                if not self._train_mask_host[hb.n_id[: hb.batch_size]].any():
                    continue
                metrics = self.step(hb, staged)
                if self.cfg.device_timeout_s > 0:
                    metrics = self.watchdog.wait(metrics, f"train step {steps}")
                n = float(metrics["num_train"])
                total_loss += float(metrics["loss"]) * n
                total_n += n
                step_drift = float(metrics.get("drift", 0.0))
                total_drift += step_drift
                total_edges += hb.num_edges
                steps += 1
                self._steps_since_refresh += 1
                if (self.cfg.refresh_drift_threshold > 0.0
                        and step_drift > self.cfg.refresh_drift_threshold):
                    self._refresh()
                    drift_refreshes += 1
                if steps >= self.max_steps:
                    break
        dt = time.perf_counter() - t0
        out = {
            "loss": total_loss / max(total_n, 1.0),
            "steps": steps,
            "drift": total_drift / max(steps, 1),
            "drift_refreshes": drift_refreshes,
            "epoch_s": dt,
            "edges_per_s": total_edges / max(dt, 1e-9),
            "staleness_steps": self._steps_since_refresh,
            **self._last_fused_plan,
        }
        self.metrics.log("train_epoch", **out)
        return out

    def evaluate(self) -> Dict[str, float]:
        """Layer-wise inference + cache refresh, then micro-F1 on all splits
        computed on the device (main.py:231-249)."""
        t0 = time.perf_counter()
        self._refresh(host_logits=False)
        tb = self.tables
        if self.mesh is None:
            tr, va, te = split_metrics_device(self.out_table, tb.y, tb.train_mask,
                                              tb.val_mask, tb.test_mask)
        else:
            tr, va, te = R.split_metrics(self.out_table, tb)
        out = {"train_acc": tr, "val_acc": va, "test_acc": te}
        self._last_eval_s = time.perf_counter() - t0  # refresh and metrics
        self.metrics.log("eval", **out, eval_s=self._last_eval_s)
        return out

    def full_forward(self, data: GraphData) -> np.ndarray:
        """Whole-graph inference on another graph with the trained model: the
        inductive eval (reference ``full_test``, main.py:99-102, on PPI's
        val/test graphs).  The eval loader's format aggregates it; the
        trainer's caches, logits table and captured graphs stay as they
        are."""
        eval_fmt = self.eval_loader.adj_format
        return full_graph_forward(
            self.model, data, self.device, loop=self.cfg.loop, norm=self.cfg.norm,
            use_aggregation=self.cfg.use_aggregation, adj_format=eval_fmt,
            x_dtype=resolve_dtype(self.cfg.x_dtype),
            **(self.blk_kwargs if eval_fmt == "block-fwd" else {}))

    def metrics_from_logits(self, logits: np.ndarray) -> Dict[str, float]:
        """Split accuracies from full-graph logits in permuted node order."""
        d = self.data
        out = {
            "train_acc": compute_micro_f1(logits, d.y, d.train_mask),
            "val_acc": compute_micro_f1(logits, d.y, d.val_mask),
            "test_acc": compute_micro_f1(logits, d.y, d.test_mask),
        }
        extra = {} if self._last_eval_s is None else {"eval_s": self._last_eval_s}
        self.metrics.log("eval", **out, **extra)
        return out

    # ---------------- checkpoint protocol (train/checkpoint.py) ----------------
    def _cache_state(self) -> Dict[str, torch.Tensor]:
        return {**{f"hist.emb.{l}": t for l, t in enumerate(self.hist.emb)},
                **{f"hist.emb_ag.{l}": t for l, t in enumerate(self.hist.emb_ag)}}

    @torch.no_grad()
    def _restore_caches(self, restored: Dict[str, torch.Tensor]) -> None:
        """Each cache from its whole table (under a mesh: this rank's rows)."""
        for k, t in self._cache_state().items():
            fill(t, restored[k])

    def checkpoint_state(self) -> Dict[str, torch.Tensor]:
        """The complete training state: parameters and BatchNorm statistics
        (``model.*``), Adam (``adam.*``), the caches, the device generator,
        and the training loader's epoch, which seeds its shuffle, and pad
        buckets: they grow with the batches seen, and the ELL width splits
        each row's sum between the ELL slots and the overflow tail, so a
        resumed run must pad as the uninterrupted one would."""
        return {
            **{f"model.{k}": v for k, v in self.model.state_dict().items()},
            **self.opt.state_arrays(),
            # under a mesh the slabs gathered: the unsharded trainer's file
            **{k: t if self.mesh is None else t.to_host()
               for k, t in self._cache_state().items()},
            "generator": self.generator.get_state(),
            "loader_epoch": torch.tensor(self.train_loader._epoch),
            "loader_buckets": torch.tensor(
                dataclasses.astuple(self.train_loader.buckets), dtype=torch.int64),
            "refresh_cursor": torch.tensor(self._refresh_cursor),
        }

    @torch.no_grad()
    def restore_checkpoint(self, restored: Dict[str, torch.Tensor]) -> None:
        """Load what :meth:`checkpoint_state` returned (tensors already
        placed and typed like it)."""
        self.model.load_state_dict({k[len("model."):]: v for k, v in restored.items()
                                    if k.startswith("model.")})
        self.opt.load_state_arrays(restored)
        self._restore_caches(restored)
        self.generator.set_state(restored["generator"].cpu())
        self.train_loader._epoch = int(restored["loader_epoch"])
        if self.train_loader._cache is None:
            # a set already held keeps the buckets it was collated under:
            # they are its final ones, which a restored set would grow to
            self.train_loader.buckets = PadBuckets(*restored["loader_buckets"].tolist())
        self._refresh_cursor = int(restored["refresh_cursor"])
        self._fused_fn = None  # a captured step holds the replaced Adam state
        self.model.drop_refresh_graphs()

    def fit(self, epochs: Optional[int] = None) -> Dict:
        """Full loop: fill, then (train, refresh + eval) per epoch
        (main.py:226-264), from ``self.epoch`` on."""
        epochs = self.cfg.epochs if epochs is None else epochs
        self.fill_history()
        best_val = best_test = 0.0
        history = []
        for epoch in range(self.epoch, epochs):
            tr = self.train_epoch()
            ev = self.evaluate()
            if ev["val_acc"] > best_val:
                best_val, best_test = ev["val_acc"], ev["test_acc"]
            history.append({**tr, **ev})
            self.epoch = epoch + 1
            if self.log and epoch % self.cfg.log_every == 0:
                print(f"Epoch {epoch:04d} loss {tr['loss']:.4f} "
                      f"train {ev['train_acc']:.4f} val {ev['val_acc']:.4f} "
                      f"test {ev['test_acc']:.4f} (best {best_test:.4f})")
        return {"best_val": best_val, "best_test": best_test, "history": history}


@torch.no_grad()
def full_graph_forward(model: ScalableGNN, data: GraphData, device, *, loop: bool = True,
                       norm: bool = True, use_aggregation: bool = True,
                       adj_format: str = "hybrid-fwd", x_dtype=torch.float32,
                       **block_kwargs) -> np.ndarray:
    """Full-graph inference on an arbitrary graph with the model's trained
    parameters, the inductive eval primitive (JAX trainer.py:703-746): the
    ``loop``/``norm`` transforms, one whole-graph eval batch (``ptr = [0,
    n]``, batch-local columns) and the layer-wise sweep into a throwaway
    f32 cache sized ``n + 1``.  Returns the ``[n, C]`` logits in the
    graph's own node order.

    The JAX function collates that batch in its loader's default COO
    format; the port has no COO kernel, so the batch takes ``adj_format``
    (the trainer's eval format, ``hybrid-fwd`` or ``block-fwd`` with the
    dense tier's ``block_kwargs``), and kernel B (or kernel A) aggregates
    the whole graph.  The model's ``_last_refresh_plan`` is left as the
    trainer's last refresh set it."""
    if loop:
        data = dataclasses.replace(data, adj_t=data.adj_t.set_diag())
    if norm:
        data = dataclasses.replace(data, adj_t=gcn_norm(data.adj_t))
    n = data.num_nodes
    ptr = np.array([0, n], dtype=np.int64)
    loader = EvalSubgraphLoader(data, ptr, device, batch_size=1, adj_format=adj_format,
                                global_cols=False, **block_kwargs)
    hist = init_history(model.cfg.num_layers, n, model.hist_dim, torch.float32, device)
    tables = make_tables(data, device, dtype=x_dtype)
    saved = getattr(model, "_last_refresh_plan", None)
    try:
        logits, _ = model.refresh(tables.x, loader, hist, vr=False,
                                  use_aggregation=use_aggregation)
    finally:
        if saved is None:
            model.__dict__.pop("_last_refresh_plan", None)
        else:
            model._last_refresh_plan = saved
    return logits
