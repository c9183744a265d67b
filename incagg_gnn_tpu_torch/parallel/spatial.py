"""Multi-device sharded GAS and Reverb/VR training over ``torch.distributed``.

The counterpart of ``incagg_gnn_tpu/parallel/spatial.py``.  The cluster set
is bin-packed over the ranks (``parallel/layout.py``, ``parallel/plan.py``):

- features, labels, masks, the history caches and the logits live in slab
  layout: each rank holds exactly its clusters' rows (``[slab, ...]``, the
  last row its trash row) on its own device;
- Reverb/VR training batches are in-batch only, so every pull a rank makes
  is local to its slab: a step moves no rows, only one ``all_reduce`` of
  the gradients, the train-row count, the loss and the BatchNorm running
  statistics;
- a GAS training step and the layer-wise refresh need out-of-batch rows
  that may live on other ranks: each round's dynamic index sets are
  compiled into a static all-to-all halo schedule (``HaloPlan``), so a
  rank exchanges only halo rows (:class:`HaloExchange`); the refresh
  collects round ``r + 1``'s halo while round ``r`` computes;
- parameters, Adam and the BatchNorm statistics are replicated: rank 0's
  are broadcast at the start, and every rank applies the same reduced
  update;
- GCN, GCNII, GraphSAGE and APPNP take every format; GAT trains Reverb on
  the hybrid pair with its transpose slot permutation and GAS on COO, PNA
  on the hybrid pair (``plan.py::PlanConfig.of``); ``parallel/
  spill_sharded.py`` keeps the caches in host memory instead.

Where JAX runs the single-device model code on each device under
``shard_map``, here each rank is a process that runs the port's
single-device model code on its own slab; the collectives are the
lockstep.  In GAS every rank pushes layer ``l`` into its slab before any
rank pulls its out-of-batch rows through the exchange, on every rank and
every round, a rank whose round is empty included (it runs the padded
batch).
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from incagg_gnn_tpu_torch.graph.csr import GraphData, gcn_norm, permute
from incagg_gnn_tpu_torch.graph.partition import partition_graph
from incagg_gnn_tpu_torch.history import HistoryState, resolve_dtype
from incagg_gnn_tpu_torch.models.base import ScalableGNN
from incagg_gnn_tpu_torch.ops.ell import tree_to
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel.mesh import Mesh
from incagg_gnn_tpu_torch.parallel.plan import (
    SHARDABLE, HaloPlan, PlanConfig, ShardPlan, StackPlan, build_plan, collate_round)
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import masked_loss
from incagg_gnn_tpu_torch.utils.heartbeat import beat
from incagg_gnn_tpu_torch.utils.metrics import compute_micro_f1

#: ``loopback`` is chosen by name only, never by ``auto``
WIRES = ("auto", "dense", "ragged", "loopback")


def resolve_wire(wire: str, backend: str) -> str:
    """``halo_wire``: ``auto`` takes the exact-payload ``ragged`` wire on
    NCCL and the padded ``dense`` one on gloo, as JAX takes ragged where it
    lowers (spatial.py:255-261).  ``loopback`` is the measuring control of
    ``scaling_bench.py`` (:class:`HaloExchange`): no collective, and wrong
    across more than one rank."""
    if wire not in WIRES:
        raise ValueError(f"unknown halo_wire {wire!r}; one of {WIRES}")
    if wire == "auto":
        return "ragged" if backend == "nccl" else "dense"
    return wire


def check_sharded(model: ScalableGNN, cfg) -> None:
    """Refuse what the sharded path does not have."""
    name = model.__class__.__name__
    if name == "PNA_JK":
        raise NotImplementedError(
            "PNA_JK sharded over devices: the JAX package has no working sharded "
            "PNA_JK to hold it against (its sharded refresh writes forward_layer's "
            "last [rows, hidden] output into the [rows, out_channels] logits slab, so "
            "the JK head never runs there; ROADMAP.md, \"JAX has no working sharded "
            "PNA_JK\"); train PNA_JK on one device")
    if name not in SHARDABLE:
        raise NotImplementedError(f"{name} sharded over devices; the sharded trainer "
                                  f"trains {', '.join(SHARDABLE)}")
    resolve_wire(cfg.halo_wire, "gloo")


class HaloExchange:
    """One rank's halo exchange of one round: ``[slab, D] -> [C_pad, D]``,
    the batch's ``n_id`` rows assembled from the local slab and the rows
    the owning ranks sent.  ``dense`` moves the padded ``[n_dev * H, D]``
    block; ``ragged`` moves each pair's true rows (the split sizes) into
    the same receive layout, so both assemble the same bits.  Called on a
    tensor it is differentiable: the backward is the transposed exchange
    over the same wire.

    ``loopback`` is JAX's comm-off control (spatial.py:84-90, 174-175): the
    receive buffer is this rank's own gathered send rows, so the staging
    gather and the assembly run and no collective does.  It exists to
    measure the wire's share (full minus loopback, ``scaling_bench.py``):
    across more than one rank its remote rows are wrong, since they read
    this rank's staging."""

    def __init__(self, plan: HaloPlan, mesh: Mesh, wire: str):
        dev = mesh.device
        self.mesh, self.wire = mesh, wire
        self.nd, self.h = plan.send_idx.shape

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)

        self.send_idx = t(plan.send_idx.reshape(-1))
        self.is_local = torch.from_numpy(plan.is_local).to(dev)[:, None]
        self.local_pos = t(plan.local_pos)
        self.remote_pos = t(plan.remote_pos)
        self.send_sizes = [int(s) for s in plan.send_sizes]
        self.recv_sizes = [int(s) for s in plan.recv_sizes]
        h = self.h
        send_rows = np.concatenate(
            [j * h + np.arange(s) for j, s in enumerate(self.send_sizes)] + [[]])
        recv_rows = np.concatenate(
            [o * h + np.arange(s) for o, s in enumerate(self.recv_sizes)] + [[]])
        self.send_rows, self.recv_rows = t(send_rows), t(recv_rows)
        self.send_idx_ragged = t(plan.send_idx.reshape(-1)[send_rows.astype(np.int64)])

    def payload_rows(self) -> int:
        """Rows this rank sends that some rank needs (Σ ``send_sizes``)."""
        return sum(self.send_sizes)

    def collect_async(self, src: torch.Tensor) -> M.Pending:
        """The collective half, issued: this rank's send rows out; the
        handle's ``wait()`` gives the flattened ``[n_dev * H, D]`` receive
        buffer."""
        if self.wire == "loopback":
            recv = src.index_select(0, self.send_idx)
            return M.Pending(lambda: recv)
        if self.wire == "ragged":
            got = M.all_to_all_async(self.mesh, src.index_select(0, self.send_idx_ragged),
                                     self.send_sizes, self.recv_sizes)
            rows = (self.nd * self.h, src.shape[1])
            return M.Pending(lambda: src.new_zeros(rows).index_copy_(0, self.recv_rows,
                                                                     got.wait()))
        return M.all_to_all_async(self.mesh, src.index_select(0, self.send_idx))

    def collect(self, src: torch.Tensor) -> torch.Tensor:
        """:meth:`collect_async`, waited for."""
        return self.collect_async(src).wait()

    def assemble(self, src: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        """The local half: the ``[C_pad, D]`` rows from the slab or the
        receive buffer."""
        return torch.where(self.is_local, src.index_select(0, self.local_pos),
                           recv.index_select(0, self.remote_pos))

    def transpose(self, g: torch.Tensor, num_rows: int) -> torch.Tensor:
        """The exchange's backward: cotangents of the assembled rows back
        to the slab rows they came from, the remote ones over the
        transposed collective."""
        d_src = g.new_zeros((num_rows, g.shape[1]))
        d_src.index_add_(0, self.local_pos, torch.where(self.is_local, g, 0.0))
        d_recv = g.new_zeros((self.nd * self.h, g.shape[1]))
        d_recv.index_add_(0, self.remote_pos, torch.where(self.is_local, 0.0, g))
        if self.wire == "ragged":
            got = M.all_to_all(self.mesh, d_recv.index_select(0, self.recv_rows),
                               self.recv_sizes, self.send_sizes)
            d_send = g.new_zeros(d_recv.shape).index_copy_(0, self.send_rows, got)
        elif self.wire == "loopback":
            d_send = d_recv
        else:
            d_send = M.all_to_all(self.mesh, d_recv)
        return d_src.index_add_(0, self.send_idx, d_send)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        return _Exchange.apply(src, self)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ex: HaloExchange):
        ctx.ex, ctx.rows = ex, src.shape[0]
        return ex.assemble(src, ex.collect(src))

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.transpose(g.contiguous(), ctx.rows), None


class PreparedGraph(NamedTuple):
    """A graph partitioned, permuted and normalized for a trainer config
    (``key``: the config fields it depends on)."""

    data: GraphData
    perm: np.ndarray
    ptr: np.ndarray
    key: tuple


def prepare_key(cfg) -> tuple:
    return (cfg.num_parts, cfg.seed, cfg.partition_method, cfg.loop, cfg.norm)


def prepare_graph(data: GraphData, cfg) -> PreparedGraph:
    """Partition and permute, then ``loop``/``norm`` (as single-device): the
    part of a trainer's set-up that every configuration of one graph with
    the same partition shares."""
    perm, ptr = partition_graph(data.adj_t, cfg.num_parts, seed=cfg.seed,
                                method=cfg.partition_method)
    data = permute(data, perm)
    if cfg.loop:
        data.adj_t = data.adj_t.set_diag()
    if cfg.norm:
        data.adj_t = gcn_norm(data.adj_t, add_self_loops=False)
    return PreparedGraph(data, perm, ptr, prepare_key(cfg))


def _slab_rows(table: np.ndarray, rows: np.ndarray, fill=0) -> np.ndarray:
    """``table``'s rows ``rows`` (``-1``: pad or trash, ``fill``)."""
    out = np.full((len(rows),) + table.shape[1:], fill, dtype=table.dtype)
    valid = rows >= 0
    out[valid] = table[rows[valid]]
    return out


class ShardedVRTrainer:
    """Data- and spatial-parallel trainer; one instance per rank.

    Reverb mode (``cfg.vr_update``): in-batch-only batches, every pull
    local, one gradient ``all_reduce`` a step.  GAS mode: in-batch +
    out-of-batch batches per rank; layer outputs are pushed into the local
    slab and out-of-batch rows pulled from the other slabs through the
    static halo all-to-all (the models' ``push_and_pull`` hook)."""

    #: the caches live on the device (the spill tier keeps them on the host)
    _alloc_device_hist = True

    def __init__(self, model: ScalableGNN, data: GraphData, cfg, mesh: Mesh,
                 log: bool = False, prepared: Optional[PreparedGraph] = None):
        """``prepared``: ``data`` already through :func:`prepare_graph` under
        this config's partition (a caller training several configurations
        of one graph prepares it once)."""
        check_sharded(model, cfg)
        t0 = time.perf_counter()
        self.mesh, self.cfg, self.model = mesh, cfg, model
        self.rank, self.n_dev, self.device = mesh.rank, mesh.world, mesh.device
        self.vr = cfg.vr_update
        self.halo_wire = resolve_wire(cfg.halo_wire, mesh.backend)
        if self.halo_wire == "loopback" and log and mesh.rank == 0:
            print("halo_wire=loopback: no collective moves the halo; rows of other "
                  "ranks read this rank's own staging, so the results are wrong across "
                  "more than one rank (a measuring control)", flush=True)

        # ---- partition / permute / transforms (as single-device) ----
        if prepared is None:
            prepared = prepare_graph(data, cfg)
        elif prepared.key != prepare_key(cfg):
            raise ValueError(f"the graph was prepared for {prepared.key}, the config "
                             f"asks for {prepare_key(cfg)}")
        data, self.perm, ptr = prepared.data, prepared.perm, prepared.ptr
        self.data, self.ptr = data, ptr
        self.multilabel = data.multilabel

        # ---- the host plan, once for all ranks ----
        plans = None
        if self.rank == 0:
            pc = PlanConfig.of(model.__class__.__name__, cfg, model.hist_dim)
            full = build_plan(data.adj_t, ptr, pc, self.n_dev, mesh.n_hosts)
            plans = [full.for_rank(r) for r in range(self.n_dev)]
        self.plan: ShardPlan = (M.scatter_objects(mesh, plans) if self.n_dev > 1
                                else plans[0])
        self.plan_s = time.perf_counter() - t0  # the host plan, on rank 0, scattered
        lay = self.layout = self.plan.layout
        slab = lay.slab
        rows = lay.row_to_node[self.rank * slab:(self.rank + 1) * slab]
        self._rows = rows

        # ---- this rank's slab of the tables, caches and logits ----
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.x_tab = t(_slab_rows(data.x.astype(np.float32), rows))
        self.y_tab = t(_slab_rows(data.y.astype(np.float32 if data.y.ndim > 1
                                                else np.int64), rows))
        self.tm_tab = t(_slab_rows(data.train_mask.astype(bool), rows, False))
        self.vm_tab = t(_slab_rows(data.val_mask.astype(bool), rows, False))
        self.em_tab = t(_slab_rows(data.test_mask.astype(bool), rows, False))
        hdt = self.hist_dtype = resolve_dtype(cfg.hist_dtype)
        L, D = model.cfg.num_layers, model.hist_dim
        self.hist = HistoryState(
            emb=[torch.zeros((slab, D), dtype=hdt, device=dev) for _ in range(L)],
            emb_ag=[torch.zeros((slab, D), dtype=hdt, device=dev) for _ in range(L)],
        ) if self._alloc_device_hist else None
        self.out_tab = torch.zeros((slab, model.cfg.out_channels), device=dev)

        # ---- replicated parameters, Adam, BatchNorm statistics ----
        self.model = model.to(dev)
        self._broadcast_state()
        self.opt = Optimizer(model, model.reg_mask(), cfg.lr, cfg.reg_weight_decay,
                             cfg.nonreg_weight_decay, cfg.grad_norm)
        self._bn = [b for n, b in model.named_buffers()
                    if n.endswith(("running_mean", "running_var"))]
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(M.seed_of(cfg.seed, self.rank))

        # ---- this rank's batches and halo plans, held on the device ----
        self._train, self._train_push = self._collate(self.plan.train)
        self._eval, _ = self._collate(self.plan.eval)
        self.use_wire(self.halo_wire)
        self._train_rounds = self.plan.train.rounds
        self._eval_rounds = self.plan.eval.rounds
        self._epoch = 0  # seeds the round order of a looped epoch
        self._steps_since_refresh = 0
        self.epoch = 0  # the next epoch to run (set by a checkpoint restore)
        self.restored_meta: Optional[dict] = None
        self.setup_s = time.perf_counter() - t0
        if log and self.rank == 0:
            print(f"ShardedVRTrainer: {self.n_dev} ranks ({mesh.backend}), "
                  f"slab={slab}, {self._train_rounds} train rounds "
                  f"({self.plan.train.fmt}), {self._eval_rounds} eval rounds "
                  f"({self.plan.eval.fmt}), halo width {self.plan.eval.halo_width}, "
                  f"wire {self.halo_wire} [{self.setup_s:.2f}s]", flush=True)

    # ------------------------------------------------------------------
    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers on every rank (one broadcast)."""
        if self.n_dev == 1:
            return
        ts = [*self.model.parameters(), *self.model.buffers()]
        ts = [t for t in ts if t.is_floating_point()]
        flat = torch.cat([t.detach().reshape(-1).float() for t in ts])
        M.broadcast(self.mesh, flat)
        with torch.no_grad():
            o = 0
            for t in ts:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()

    def _collate(self, sp: StackPlan):
        """Rank's batch of every round on the device (a repeated group, of a
        rank with fewer groups than rounds, shares its tensors), and each
        round's ``(push_idx, batch_size)`` on the host."""
        groups = sp.groups[self.rank]
        held, host = {}, {}
        out, push = [], []
        for i in range(sp.rounds):
            j = i % max(len(groups), 1)
            if j not in held:
                b = collate_round(self.data.adj_t, self.ptr, self.plan, sp, self.rank, i)
                host[j] = (b.push_idx, b.batch_size)
                held[j] = tree_to(b, self.device)
            out.append(held[j])
            push.append(host[j])
        return out, push

    def use_wire(self, wire: str) -> None:
        """Move the halo over ``wire`` (a ``halo_wire`` value) from here on:
        the plan serves every wire, so ``scaling_bench`` times the wires on
        one trainer.  The spill tier's staged GAS exchanges keep the wire
        they were built with."""
        self.halo_wire = resolve_wire(wire, self.mesh.backend)
        self._train_halos = self._exchanges(self.plan.train)
        self._eval_halos = self._exchanges(self.plan.eval)

    def _exchanges(self, sp: StackPlan) -> Optional[List[HaloExchange]]:
        if sp.halos is None:
            return None
        return [HaloExchange(per[self.rank], self.mesh, self.halo_wire) for per in sp.halos]

    def _inputs(self, batch):
        y = self.y_tab.index_select(0, batch.push_idx)
        rows = torch.arange(batch.push_idx.shape[0], device=self.device)
        mask = self.tm_tab.index_select(0, batch.push_idx) & (rows < batch.batch_size)
        return y, mask

    def _reduce(self, loss: torch.Tensor, n: torch.Tensor):
        """One ``all_reduce`` of the gradients weighted by this rank's
        train-row count ``n``, ``n`` itself, the weighted loss and the new
        BatchNorm running statistics; the gradients become the global mean
        over train rows (JAX spatial.py:750-758) and the statistics their
        mean over ranks.  Returns the global loss and row count."""
        params = self.opt.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        parts = [*(p.grad.reshape(-1) * n for p in params), n.reshape(1),
                 (loss.detach() * n).reshape(1), *(b.reshape(-1) for b in self._bn)]
        flat = M.all_reduce(self.mesh, torch.cat(parts))
        g = sum(p.numel() for p in params)
        n_tot = flat[g]
        denom = n_tot.clamp(min=1.0)
        with torch.no_grad():
            o = 0
            for p in params:
                p.grad.copy_((flat[o:o + p.numel()] / denom).view_as(p))
                o += p.numel()
            o = g + 2
            for b in self._bn:
                b.copy_((flat[o:o + b.numel()] / self.n_dev).view_as(b))
                o += b.numel()
        return flat[g + 1] / denom, n_tot

    def _vr_caches(self, i: int):
        """What round ``i``'s Reverb step reads as its caches."""
        return self.hist

    def _vr_step(self, i: int):
        """One shard-local Reverb step on round ``i`` (JAX ``_vr_step_core``)."""
        cfg, model = self.cfg, self.model
        batch = self._train[i]
        hist = self._vr_caches(i)
        x = self.x_tab.index_select(0, batch.n_id)
        y, mask = self._inputs(batch)
        self.opt.zero_grad()
        out, _ = model.forward_vr(x, batch, hist, self.generator, True, cfg.drift_norm)
        loss, n = masked_loss(out, y, mask, self.multilabel)
        loss.backward()
        loss_tot, n_tot = self._reduce(loss, n)
        self.opt.step()
        return loss_tot, n_tot

    def _gas_step(self, i: int):
        """One batch-parallel GAS step on round ``i`` (JAX ``_make_gas_step``):
        the features and every layer's out-of-batch rows come through the
        round's halo exchange."""
        cfg, model = self.cfg, self.model
        batch, exchange = self._train[i], self._train_halos[i]
        x = exchange(self.x_tab)
        y, mask = self._inputs(batch)
        self.opt.zero_grad()
        out = self._gas_forward(i, x, batch, exchange)
        loss, n = masked_loss(out, y, mask, self.multilabel)
        loss.backward()
        loss_tot, n_tot = self._reduce(loss, n)
        self.opt.step()
        self._after_gas_step(i)
        return loss_tot, n_tot

    def _gas_forward(self, i: int, x: torch.Tensor, batch,
                     exchange: HaloExchange) -> torch.Tensor:
        """Round ``i``'s GAS forward: each layer pushed into the slab, the
        out-of-batch rows pulled through the round's exchange."""
        cfg, model = self.cfg, self.model
        model._shard_halo = exchange
        try:
            out, _ = model.forward_gas(x, batch, self.hist.emb, self.generator, True,
                                       aggregate_combined=cfg.aggregate_combined,
                                       use_aggregation=cfg.use_aggregation)
        finally:
            model._shard_halo = None
        return out

    def _after_gas_step(self, i: int) -> None:
        self._zero_trash()

    @torch.no_grad()
    def _zero_trash(self) -> None:
        """Padded rows push zeros into the trash row; keep it zero."""
        for t in (*self.hist.emb, *self.hist.emb_ag):
            t[-1].zero_()

    # ------------------------------------------------------------------
    def train_epoch(self) -> Dict[str, float]:
        """One epoch over every round.  Reverb without a ``max_steps`` cap
        takes the rounds in stack order (JAX's scanned epoch); capped, and
        in GAS, in the order ``default_rng((seed, epoch)).permutation`` (JAX
        spatial.py:1052-1130)."""
        cap = self.cfg.max_steps
        fused = self.vr and not (0 < cap < self._train_rounds)
        if fused:
            order = np.arange(self._train_rounds)
        else:
            order = np.random.default_rng((self.cfg.seed, self._epoch)).permutation(
                self._train_rounds)
            self._epoch += 1
        step = self._vr_step if self.vr else self._gas_step
        t0 = time.perf_counter()
        losses, ns = [], []
        steps = edges = 0
        for i in order:
            beat()
            loss, n = step(int(i))
            losses.append(loss)
            ns.append(n)
            edges += self.plan.train.round_edges[i]
            steps += 1
            self._steps_since_refresh += 1
            if not fused and steps >= cap > 0:
                break
        ls, ns_ = torch.stack(losses).double(), torch.stack(ns).double()
        total_n = float(ns_.sum())
        loss = float((ls * ns_).sum()) / max(total_n, 1.0)
        dt = time.perf_counter() - t0
        return {"loss": loss, "steps": steps, "epoch_s": dt,
                "edges_per_s": edges / max(dt, 1e-9),
                "staleness_steps": self._steps_since_refresh}

    @torch.no_grad()
    def refresh(self, host_logits: bool = True) -> Optional[np.ndarray]:
        """The layer-wise refresh over every eval round (JAX
        ``_make_refresh_layer``): per layer, each round's halo rows come
        from the layer's source table (the features at layer 0, else
        ``M_in[layer]``, which this pass does not write), the round's batch
        writes its caches and, at the last layer, its logits.  Returns the
        ``[N, C]`` logits in (permuted) node order on every rank."""
        self._steps_since_refresh = 0
        for layer in range(self.model.cfg.num_layers):
            self._refresh_layer(layer, self.hist)
        self._zero_trash()
        if not host_logits:
            return None
        return self.logits()

    def _refresh_layer(self, layer: int, hist: HistoryState) -> None:
        """One layer pass of the refresh over every eval round, on ``hist``,
        its halo exchange software-pipelined across the rounds (JAX
        spatial.py:924-985): the pass's source table is constant over it,
        so round ``r + 1``'s collect is issued before round ``r`` computes
        from the receive buffer collected ahead of it.  The rounds assemble
        and compute as they would in turn, so the results are the same bits;
        two receive buffers are alive at once."""
        src = self.x_tab if layer == 0 else hist.emb[layer]
        rounds = list(zip(self._eval, self._eval_halos))
        pending = rounds[0][1].collect_async(src)
        for r, (batch, ex) in enumerate(rounds):
            beat()
            ahead = rounds[r + 1][1].collect_async(src) if r + 1 < len(rounds) else None
            recv = pending.wait()
            self.model._refresh_batch(layer, True, True, hist, self.x_tab, self.out_tab,
                                      batch,
                                      gather=lambda t, ex=ex, recv=recv: ex.assemble(t, recv))
            pending = ahead

    fill_history = refresh

    def logits(self) -> np.ndarray:
        """Every rank's logits slab gathered into node order."""
        out_rows = M.all_gather(self.mesh, self.out_tab).cpu().numpy()
        valid = self.layout.row_to_node >= 0
        logits = np.zeros((self.data.num_nodes, out_rows.shape[1]), np.float32)
        logits[self.layout.row_to_node[valid]] = out_rows[valid]
        return logits

    def evaluate(self) -> Dict[str, float]:
        """Refresh, then the split accuracies from sums over the ranks'
        slabs (micro-F1's counts for multi-label); a few scalars travel."""
        self.refresh(host_logits=False)
        stats = []
        for m in (self.tm_tab, self.vm_tab, self.em_tab):
            if self.y_tab.ndim == 1:
                hit = (self.out_tab.argmax(dim=-1) == self.y_tab) & m
                stats += [hit.sum(), m.sum(), m.sum()]
            else:
                pred, true = (self.out_tab > 0) & m[:, None], (self.y_tab > 0.5) & m[:, None]
                stats += [(true & pred).sum(), (~true & pred).sum(), (true & ~pred).sum()]
        s = M.all_reduce(self.mesh, torch.stack(stats).double()).tolist()
        accs = []
        for a, b, c in zip(s[0::3], s[1::3], s[2::3]):
            if self.y_tab.ndim == 1:
                accs.append(a / max(b, 1.0))
            else:
                p, r = a / max(a + b, 1.0), a / max(a + c, 1.0)
                accs.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
        return dict(zip(("train_acc", "val_acc", "test_acc"), accs))

    def metrics_from_logits(self, logits: np.ndarray) -> Dict[str, float]:
        d = self.data
        return {"train_acc": compute_micro_f1(logits, d.y, d.train_mask),
                "val_acc": compute_micro_f1(logits, d.y, d.val_mask),
                "test_acc": compute_micro_f1(logits, d.y, d.test_mask)}

    def full_forward(self, data: GraphData) -> np.ndarray:
        """Inductive eval on another graph (JAX spatial.py:1040-1050): a
        single-device whole-graph forward with the replicated parameters,
        which the caller runs on rank 0."""
        from incagg_gnn_tpu_torch.train.trainer import full_graph_forward

        return full_graph_forward(self.model, data, self.device, loop=self.cfg.loop,
                                  norm=self.cfg.norm,
                                  use_aggregation=self.cfg.use_aggregation)

    # ---------------- the sharded checkpoint protocol ----------------
    def replicated_checkpoint_state(self) -> Dict[str, torch.Tensor]:
        """What every rank holds alike: parameters and BatchNorm statistics,
        Adam, and the epoch counter that seeds the round order."""
        return {**{f"model.{k}": v for k, v in self.model.state_dict().items()},
                **self.opt.state_arrays(), "round_epoch": torch.tensor(self._epoch)}

    def hist_arrays(self) -> Dict[str, torch.Tensor]:
        """This rank's own state: its slab of both caches and its generator."""
        return {**{f"hist.emb.{l}": t for l, t in enumerate(self.hist.emb)},
                **{f"hist.emb_ag.{l}": t for l, t in enumerate(self.hist.emb_ag)},
                "generator": self.generator.get_state()}

    @torch.no_grad()
    def restore_replicated(self, restored: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict({k[len("model."):]: v for k, v in restored.items()
                                    if k.startswith("model.")})
        self.opt.load_state_arrays(restored)
        self._epoch = int(restored["round_epoch"])

    @torch.no_grad()
    def set_hist_arrays(self, arrays: Dict[str, torch.Tensor]) -> None:
        for k, t in self.hist_arrays().items():
            if k != "generator":
                t.copy_(arrays[k])
        self.generator.set_state(arrays["generator"].cpu())

    def fit(self, epochs: Optional[int] = None) -> Dict[str, float]:
        epochs = self.cfg.epochs if epochs is None else epochs
        self.refresh(host_logits=False)
        best_val = best_test = 0.0
        for _ in range(self.epoch, epochs):
            self.train_epoch()
            ev = self.evaluate()
            if ev["val_acc"] > best_val:
                best_val, best_test = ev["val_acc"], ev["test_acc"]
        return {"best_val": best_val, "best_test": best_test}
