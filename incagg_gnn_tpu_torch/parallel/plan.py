"""The host plan of the sharded trainer, in numpy.

The counterpart of the host half of ``incagg_gnn_tpu/parallel/spatial.py``
(``_DevBatch``, ``HaloPlan``, ``_build_train_batches``,
``_build_eval_batches``, ``_build_gas_stacks``, ``_build_halo_plans``,
``_block_buckets``, ``_hybrid_buckets`` and ``_pack``), over the port's own
builders.  :func:`build_plan` runs once for all ranks (on rank 0, which
scatters each rank its part): the slab layout, the cluster groups of every
device, and the pads, format buckets and halo width that every device's
batches share, since one rank choosing its own would break the
all-to-all's shapes.  Each rank then collates only its own batches
(:func:`collate_round`).

Row spaces: a Reverb/VR training batch indexes the local slab (its pulls
are all local); a GAS or eval batch carries ``n_id`` in *global* row space
(``owner = row // slab``), padded with its device's own global trash row,
and its halo plan says where each of those rows comes from.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import numpy as np

from incagg_gnn_tpu_torch.graph.relabel import (
    relabel_one_hop, relabel_one_hop_within_batch)
from incagg_gnn_tpu_torch.loader import SubgraphBatch
from incagg_gnn_tpu_torch.ops.block import (
    BF16, _tile_itemsize, build_bi_block_hybrid, build_block_hybrid, marginal_thresh,
    measure_block_tier, plan_block_tier_rb, transpose_csr_host)
from incagg_gnn_tpu_torch.ops.ell import build_bi_hybrid_adj, build_hybrid_adj, ell_buckets
from incagg_gnn_tpu_torch.ops.spmm import build_padded_adj
from incagg_gnn_tpu_torch.parallel.layout import (
    ShardLayout, build_shard_layout, build_shard_layout_hierarchical)

#: the models whose sums and means the dense tier serves (JAX spatial.py:278)
BLOCKABLE = ("GCN", "GCN2", "APPNP", "GraphSAGE")


def _round_up(x: int, a: int) -> int:
    return max(a, ((x + a - 1) // a) * a)


@dataclasses.dataclass
class DevBatch:
    """One device's host batch in slab row space."""

    adj_args: tuple  # (rowptr, col, value)
    n_id_rows: np.ndarray  # global rows (GAS/eval) or local rows (VR train)
    push_idx_local: np.ndarray
    batch_size: int
    num_nodes: int


class HaloPlan(NamedTuple):
    """The static halo-exchange schedule of one device in one round.

    ``send_idx[j]`` lists the local slab rows this device sends to device
    ``j`` (padded with the local trash row); the batch's ``n_id`` positions
    come from the local slab (``is_local``, ``local_pos``) or from the
    flattened ``[n_dev * H, D]`` receive buffer (``remote_pos`` = owner * H
    + slot).  ``send_sizes`` / ``recv_sizes`` are the true row counts of
    each pair."""

    send_idx: np.ndarray  # [n_dev (dst), H] int32
    is_local: np.ndarray  # [C_pad] bool
    local_pos: np.ndarray  # [C_pad] int32
    remote_pos: np.ndarray  # [C_pad] int32
    send_sizes: np.ndarray  # [n_dev (dst)] int32
    recv_sizes: np.ndarray  # [n_dev (src)] int32


@dataclasses.dataclass
class StackPlan:
    """What every device's batches of one set share.  ``groups[d]`` are
    device ``d``'s cluster groups; round ``i`` trains (or refreshes)
    ``groups[d][i % len(groups[d])]``, so a device with fewer groups
    repeats its batches; ``halos[i][d]`` is device ``d``'s plan of round
    ``i`` (GAS and eval sets; None elsewhere, and for other ranks' entries
    in a rank's copy)."""

    mode: str  # "ib" (VR training, local rows) or "gas" (global rows)
    groups: List[List[np.ndarray]]
    rounds: int
    fmt: str  # "bi-block", "bi", "block", "fwd" or "coo"
    fmt_args: Optional[dict]
    r_pad: int
    c_pad: int
    e_pad: int
    round_edges: List[int]
    halos: Optional[List[List[Optional[HaloPlan]]]] = None

    @property
    def halo_width(self) -> int:
        return 0 if not self.halos else int(next(
            h for h in self.halos[0] if h is not None).send_idx.shape[1])


@dataclasses.dataclass
class ShardPlan:
    """The whole host plan: the slab layout, the training set and the eval
    (refresh) set, and the formats the trainer chose."""

    layout: ShardLayout
    train: StackPlan
    eval: StackPlan
    adj_format: str  # "hybrid" or "coo"

    def for_rank(self, rank: int) -> "ShardPlan":
        """This plan with only ``rank``'s halo plans (what a rank needs)."""

        def own(sp: StackPlan) -> StackPlan:
            if sp.halos is None:
                return sp
            return dataclasses.replace(sp, halos=[
                [h if d == rank else None for d, h in enumerate(per)] for per in sp.halos])

        return dataclasses.replace(self, train=own(self.train), eval=own(self.eval))


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """The trainer's choices that shape the plan (JAX spatial.py:262-293)."""

    vr: bool
    adj_format: str  # "hybrid" or "coo"
    eval_block: bool
    eval_block_force: bool
    train_block: bool
    train_block_force: bool
    batch_size: int
    eval_batch_size: int
    hist_dtype: str
    hist_dim: int

    @classmethod
    def of(cls, model_name: str, cfg, hist_dim: int) -> "PlanConfig":
        adj_format = ("coo" if cfg.adj_format == "coo" or cfg.edge_dropout > 0.0
                      else "hybrid")
        blockable = model_name in BLOCKABLE
        eval_block = (blockable and adj_format == "hybrid"
                      and cfg.adj_format in ("auto", "block"))
        eval_block_force = blockable and cfg.adj_format == "block"
        both = cfg.vr_update and cfg.aggregate_combined
        return cls(vr=cfg.vr_update, adj_format=adj_format, eval_block=eval_block,
                   eval_block_force=eval_block_force, train_block=eval_block and both,
                   train_block_force=eval_block_force and both,
                   batch_size=cfg.batch_size, eval_batch_size=cfg.eval_batch_size,
                   hist_dtype=cfg.hist_dtype, hist_dim=int(hist_dim))


def choose_layout(ptr: np.ndarray, adj, n_dev: int, n_hosts: int = 1) -> ShardLayout:
    """The slab layout (JAX spatial.py:309-323): the hierarchical packer on
    a ``(hosts x chips)`` mesh, the affinity packer with one "host" per
    device on a flat mesh of more than one device, else the size packer."""
    if n_hosts > 1:
        return build_shard_layout_hierarchical(ptr, adj.rowptr, adj.col, n_hosts,
                                               n_dev // n_hosts)
    if n_dev > 1:
        return build_shard_layout_hierarchical(ptr, adj.rowptr, adj.col, n_dev, 1)
    return build_shard_layout(ptr, n_dev)


class _Planner:
    def __init__(self, adj, ptr: np.ndarray, layout: ShardLayout, pc: PlanConfig):
        self.adj, self.ptr, self.layout, self.pc = adj, ptr, layout, pc
        self.n_dev = layout.n_dev

    def clusters_of_dev(self) -> List[np.ndarray]:
        return [np.nonzero(self.layout.dev_of_cluster == d)[0] for d in range(self.n_dev)]

    @staticmethod
    def group(clusters: np.ndarray, k: int) -> List[np.ndarray]:
        return [clusters[i : i + k] for i in range(0, len(clusters), k)] or [
            np.empty(0, np.int64)]

    def groups(self, k: int) -> List[List[np.ndarray]]:
        return [self.group(c, k) for c in self.clusters_of_dev()]

    def raw(self, mode: str, groups: List[List[np.ndarray]]) -> List[List[DevBatch]]:
        return [[dev_batch(self.adj, self.ptr, self.layout, d, g, mode) for g in per]
                for d, per in enumerate(groups)]

    def hybrid_buckets(self, raw, c_pad) -> dict:
        """Common ELL/overflow buckets across every device's batches."""
        degs, tdegs = [], []
        for lst in raw:
            for b in lst:
                rowptr, col, _ = b.adj_args
                degs.append(np.diff(rowptr))
                tdegs.append(np.bincount(col, minlength=c_pad) if col.size
                             else np.zeros(1, np.int64))
        k, ovf = ell_buckets(degs)
        k_t, ovf_t = ell_buckets(tdegs)
        return {"k": k, "k_t": k_t, "ovf_pad": ovf, "ovf_pad_t": ovf_t}

    def block_buckets(self, raw, r_pad, c_pad, rounds, force: bool,
                      bi: bool = False) -> Optional[dict]:
        """One thresh/k/ovf/nb bucket over every device's batches, gated by
        the cost model on the largest batch and a per-device budget of
        resident tiles (``INCAGG_SHARD_TILE_BUDGET_MB``, JAX
        spatial.py:481-542).  With ``bi``, the transpose direction too."""
        a_dtype = BF16 if self.pc.hist_dtype == "bfloat16" else np.float32
        ai = _tile_itemsize(a_dtype)
        d_hint = self.pc.hist_dim
        batches = [b for lst in raw for b in lst]
        if not batches:
            return None
        big = max(batches, key=lambda b: b.adj_args[1].size)
        plan = plan_block_tier_rb(big.adj_args[0], big.adj_args[1], c_pad,
                                  x_itemsize=ai, a_itemsize=ai, d_hint=d_hint)
        if plan is not None:
            th, rb = plan
        elif force:
            th, rb = marginal_thresh(ai, ai, d_hint), 128
        else:
            return None

        def size_dir(mk_csr, rp, cp):
            nb, rem_degs = 0, []
            for b in batches:
                rowptr, col = mk_csr(b)
                total, rem_deg = measure_block_tier(rowptr, col, rp, cp, th, rb_rows=rb)
                nb = max(nb, total)
                rem_degs.append(rem_deg)
            nb = max(nb, -(-rp // rb) * 4)  # empty-device batches: all filler
            k, ovf = ell_buckets(rem_degs, locality_kink=not bi)
            return nb, k, ovf

        nb, k, ovf = size_dir(lambda b: b.adj_args[:2], r_pad, c_pad)
        args = {"thresh": th, "k": k, "ovf_pad": ovf, "nb_pad": nb,
                "a_dtype": a_dtype, "rb_rows": rb}
        tiles = nb
        if bi:
            nb_t, k_t, ovf_t = size_dir(
                lambda b: transpose_csr_host(*b.adj_args, c_pad)[:2], c_pad, r_pad)
            args.update({"k_t": k_t, "ovf_pad_t": ovf_t, "nb_pad_t": nb_t})
            tiles += nb_t
        budget = int(os.environ.get("INCAGG_SHARD_TILE_BUDGET_MB", "4096")) << 20
        if not force and tiles * rb * 128 * ai * rounds > budget:
            return None
        return args

    def train_vr(self) -> StackPlan:
        """IB-only batches in local rows (JAX spatial.py:404-472)."""
        pc = self.pc
        groups = self.groups(pc.batch_size)
        rounds = max(len(g) for g in groups)
        raw = self.raw("ib", groups)
        max_r = max([1] + [b.batch_size for lst in raw for b in lst])
        max_e = max([1] + [b.adj_args[1].size for lst in raw for b in lst])
        blk = None
        if pc.train_block:
            rb_pad = _round_up(max_r, 128)  # the tile format needs 128-aligned
            blk = self.block_buckets(raw, rb_pad, rb_pad, rounds,
                                     force=pc.train_block_force, bi=True)
        if blk is not None:
            r_pad, fmt, fmt_args = rb_pad, "bi-block", blk
        else:
            r_pad = _round_up(max_r, 8)
            fmt_args = (self.hybrid_buckets(raw, r_pad) if pc.adj_format != "coo"
                        else None)
            fmt = "bi" if fmt_args else "coo"
        return StackPlan("ib", groups, rounds, fmt, fmt_args, r_pad, r_pad,
                         _round_up(max_e, 8), self.round_edges(raw, rounds))

    def gas(self, group_size: int, try_block: bool = False,
            train: bool = False) -> StackPlan:
        """IB+OB batches in global rows and their halo plans (JAX
        spatial.py:544-604).  The JAX package packs a GAS training set
        forward-only and lets XLA differentiate it; the port's kernel B has
        no autograd, so a training set (``train``) takes the transpose pair
        (``bi``) over the same buckets, as the port's single-device GAS
        training does."""
        pc, lay = self.pc, self.layout
        groups = self.groups(group_size)
        rounds = max(len(g) for g in groups)
        raw = self.raw("gas", groups)
        flat = [b for lst in raw for b in lst]
        max_r = max([1] + [b.batch_size for b in flat])
        max_c = max([1] + [b.num_nodes for b in flat])
        max_e = max([1] + [b.adj_args[1].size for b in flat])
        blk = None
        if try_block and pc.eval_block:
            rb_pad, cb_pad = _round_up(max_r, 128), _round_up(max_c, 128)
            blk = self.block_buckets(raw, rb_pad, cb_pad, rounds,
                                     force=pc.eval_block_force)
        if blk is not None:
            r_pad, c_pad, fmt, fmt_args = rb_pad, cb_pad, "block", blk
        else:
            r_pad, c_pad = _round_up(max_r, 8), _round_up(max_c, 8)
            fmt_args = (self.hybrid_buckets(raw, c_pad) if pc.adj_format != "coo"
                        else None)
            fmt = ("bi" if train else "fwd") if fmt_args else "coo"
        n_ids = [[padded_n_id(raw[d][i % len(raw[d])] if raw[d] else None, c_pad,
                              d * lay.slab + lay.local_trash())
                  for d in range(self.n_dev)] for i in range(rounds)]
        return StackPlan("gas", groups, rounds, fmt, fmt_args, r_pad, c_pad,
                         _round_up(max_e, 8), self.round_edges(raw, rounds),
                         halos=build_halo_plans(lay, n_ids))

    def round_edges(self, raw, rounds: int) -> List[int]:
        return [sum(len(lst[i % len(lst)].adj_args[1]) for lst in raw if lst)
                for i in range(rounds)]


def dev_batch(adj, ptr: np.ndarray, layout: ShardLayout, d: int,
              cids: np.ndarray, mode: str) -> DevBatch:
    """Device ``d``'s host batch of the clusters ``cids``: IB-only in local
    rows (``ib``), or IB+OB with ``n_id`` in global rows (``gas``)."""
    idx = (np.concatenate([np.arange(ptr[c], ptr[c + 1], dtype=np.int64) for c in cids])
           if len(cids) else np.empty(0, np.int64))
    push_local = layout.node_to_row[idx] - d * layout.slab
    if mode == "ib":
        rowptr, col, value, _ = relabel_one_hop_within_batch(adj, idx)
        return DevBatch((rowptr, col, value), push_local, push_local, len(idx), len(idx))
    rowptr, col, value, n_id = relabel_one_hop(adj, idx)
    return DevBatch((rowptr, col, value), layout.node_to_row[n_id], push_local,
                    len(idx), len(n_id))


def padded_n_id(b: Optional[DevBatch], c_pad: int, fill: int) -> np.ndarray:
    n_id = np.full(c_pad, fill, dtype=np.int32)
    if b is not None:
        n_id[: b.num_nodes] = b.n_id_rows
    return n_id


def build_halo_plans(layout: ShardLayout, n_ids) -> List[List[HaloPlan]]:
    """The static all-to-all schedule of every round (JAX
    spatial.py:606-666) from each device's padded global-row ``n_id``
    (``n_ids[round][device]``): the send lists are the sorted unique rows
    each device requests of each owner, and ``H`` the widest of them over
    every round and pair, rounded up to 8."""
    nd, slab, trash = layout.n_dev, layout.slab, layout.local_trash()
    round_sends = []  # [round][src][dst] -> global rows
    h_max = 1
    for per_round in n_ids:
        sends = [[None] * nd for _ in range(nd)]
        for d in range(nd):
            rows = per_round[d]
            owner = rows // slab
            for o in range(nd):
                if o == d:
                    continue
                sends[o][d] = np.unique(rows[owner == o])
                h_max = max(h_max, len(sends[o][d]))
        round_sends.append(sends)
    h = _round_up(h_max, 8)

    plans = []
    for per_round, sends in zip(n_ids, round_sends):
        per_dev = []
        for d in range(nd):
            rows = per_round[d]
            owner = rows // slab
            is_local = owner == d
            local_pos = np.where(is_local, rows - d * slab, trash).astype(np.int32)
            remote_pos = np.zeros(len(rows), np.int32)
            for o in range(nd):
                if o == d:
                    continue
                m = owner == o
                if not m.any():
                    continue
                slot = np.searchsorted(sends[o][d], rows[m])
                remote_pos[m] = o * h + slot
            send_idx = np.full((nd, h), trash, np.int32)
            send_sizes = np.zeros(nd, np.int32)
            recv_sizes = np.zeros(nd, np.int32)
            for j in range(nd):
                if j != d and sends[d][j] is not None:
                    lst = sends[d][j]
                    send_idx[j, : len(lst)] = (lst - d * slab).astype(np.int32)
                    send_sizes[j] = len(lst)
                if j != d and sends[j][d] is not None:
                    recv_sizes[j] = len(sends[j][d])
            per_dev.append(HaloPlan(send_idx=send_idx, is_local=is_local,
                                    local_pos=local_pos, remote_pos=remote_pos,
                                    send_sizes=send_sizes, recv_sizes=recv_sizes))
        plans.append(per_dev)
    return plans


def build_plan(adj, ptr: np.ndarray, pc: PlanConfig, n_dev: int,
               n_hosts: int = 1) -> ShardPlan:
    """The host plan of a sharded run over ``n_dev`` devices, from the
    partitioned, permuted and normalized graph ``adj`` and its cluster
    pointer ``ptr``."""
    layout = choose_layout(ptr, adj, n_dev, n_hosts)
    pl = _Planner(adj, np.asarray(ptr, dtype=np.int64), layout, pc)
    train = pl.train_vr() if pc.vr else pl.gas(pc.batch_size, train=True)
    return ShardPlan(layout=layout, train=train,
                     eval=pl.gas(pc.eval_batch_size, try_block=True),
                     adj_format=pc.adj_format)


def collate_round(adj, ptr: np.ndarray, plan: ShardPlan, sp: StackPlan, rank: int,
                  i: int) -> SubgraphBatch:
    """Rank ``rank``'s batch of round ``i`` of the set ``sp``, padded to the
    set's shared pads and buckets, as numpy arrays (JAX ``_pack``)."""
    lay = plan.layout
    groups = sp.groups[rank]
    b = dev_batch(adj, ptr, lay, rank, groups[i % len(groups)], sp.mode) if groups else None
    fill = rank * lay.slab + lay.local_trash() if sp.mode == "gas" else lay.local_trash()
    return pack(b, sp, lay.local_trash(), fill)


def pack(b: Optional[DevBatch], sp: StackPlan, trash_local: int,
         n_id_fill: int) -> SubgraphBatch:
    """Pad one host batch to the set's pads and buckets."""
    if b is None:
        b = DevBatch((np.zeros(1, np.int64), np.empty(0, np.int32), None),
                     np.empty(0, np.int64), np.empty(0, np.int64), 0, 0)
    rowptr, col, value = b.adj_args
    r_pad, c_pad, a = sp.r_pad, sp.c_pad, sp.fmt_args
    if sp.fmt == "block":
        adj = build_block_hybrid(rowptr, col, value, r_pad, c_pad, thresh=a["thresh"],
                                 a_dtype=a["a_dtype"], k=a["k"], ovf_pad=a["ovf_pad"],
                                 nb_pad=a["nb_pad"], rb_rows=a["rb_rows"])
    elif sp.fmt == "bi-block":
        adj = build_bi_block_hybrid(
            rowptr, col, value, r_pad, c_pad, thresh=a["thresh"], a_dtype=a["a_dtype"],
            k=a["k"], k_t=a["k_t"], ovf_pad=a["ovf_pad"], ovf_pad_t=a["ovf_pad_t"],
            nb_pad=a["nb_pad"], nb_pad_t=a["nb_pad_t"], rb_rows=a["rb_rows"])
    elif sp.fmt == "bi":
        adj = build_bi_hybrid_adj(rowptr, col, value, r_pad, c_pad, **a)
    elif sp.fmt == "fwd":
        adj = build_hybrid_adj(rowptr, col, value, r_pad, c_pad, k=a["k"],
                               ovf_pad=a["ovf_pad"])
    else:
        adj = build_padded_adj(rowptr, col, value, r_pad, c_pad, sp.e_pad)
    n_id = np.full(c_pad, n_id_fill, dtype=np.int64)
    n_id[: b.num_nodes] = b.n_id_rows
    push = np.full(r_pad, trash_local, dtype=np.int64)
    push[: b.batch_size] = b.push_idx_local
    return SubgraphBatch(adj=adj, n_id=n_id, push_idx=push, batch_size=b.batch_size,
                         num_nodes=b.num_nodes)
