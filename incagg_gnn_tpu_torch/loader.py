"""Subgraph batch construction with static (padded) shapes.

Port of ``incagg_gnn_tpu/loader.py`` (reference ``SubgraphLoader`` /
``EvalSubgraphLoader``, loader.py:119-284).  A batch is a group of clusters:
``n_id[:batch_size]`` are the in-batch (IB) node ids — contiguous cluster
ranges in the permuted order — and ``n_id[batch_size:]`` their out-of-batch
(OB) one-hop neighbors.  Batches are padded to shared bucket sizes; padded
node slots index the zero trash row ``N`` and padded edges weigh 0.

Collate modes: ``gas`` (full IB+OB graph), ``ib`` (IB-only graph for
Reverb/VR training) and ``ns`` (the ``gas`` graph with each row capped at
``num_neighbors`` sampled entries, drawn anew every epoch and step).
Formats: ``block``/``block-fwd`` (dense tiles + hybrid remainder, training
pair / forward-only), ``hybrid``/``hybrid-fwd`` and ``coo`` (a padded edge
list, for edge dropout and the IB-only ablation).  The collate is numpy;
:meth:`SubgraphLoader.to_device` turns a batch into tensors on the
loader's device.  On a CUDA device it stages through pinned host memory
with ``non_blocking`` copies on the loader's own copy stream and records an
event; a consumer calls :meth:`HostBatch.wait` before it
uses the batch, so collate and staging may run on a prefetch thread
(``utils/prefetch.py``) while the device computes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from incagg_gnn_tpu_torch.graph.csr import GraphData
from incagg_gnn_tpu_torch.graph.relabel import (
    relabel_one_hop, relabel_one_hop_within_batch, sample_neighbors)
from incagg_gnn_tpu_torch.ops.block import (
    _tile_itemsize, build_bi_block_hybrid, build_block_hybrid,
    marginal_thresh, measure_block_tier, nonempty_tiles, plan_block_tier_rb,
    transpose_csr_host)
from incagg_gnn_tpu_torch.ops.ell import (
    HybridAdj, build_bi_hybrid_adj, build_hybrid_adj, choose_k, ell_buckets, tree_to)
from incagg_gnn_tpu_torch.ops.spmm import build_padded_adj

log = logging.getLogger(__name__)

#: device-cache budget when the trainer measured none (bytes)
_DEFAULT_BUDGET = 1_500_000_000


def _grow(new_kv, k, ovf):
    """Unpack an ``ell_buckets`` result and flag whether it grew."""
    nk, novf = new_kv
    return nk, novf, (nk, novf) != (k, ovf)


def _host_bytes(obj) -> int:
    """Bytes of the numpy arrays in a collated batch's container tree."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, tuple):
        return sum(_host_bytes(v) for v in obj)
    return 0


class SubgraphBatch(NamedTuple):
    """A batch's arrays (numpy after collate, tensors after ``.to``).

    ``n_id`` padding points at the trash row ``N``; ``push_idx[i]`` equals
    ``n_id[i]`` for IB rows and ``N`` otherwise, so writes of per-row
    results into an ``[N+1, D]`` cache are always safe."""

    adj: object  # rows = IB (padded), cols = IB+OB (padded)
    n_id: np.ndarray  # [C_pad] int64
    push_idx: np.ndarray  # [R_pad] int64
    batch_size: int  # true IB count
    num_nodes: int  # true IB+OB count

    def to(self, device, pinned: bool = False) -> "SubgraphBatch":
        return tree_to(self, device, pinned)


def _tensors(obj):
    """The tensors of a container tree."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _tensors(v)


@dataclasses.dataclass
class HostBatch:
    """Host metadata + the device batch. Iterating a loader yields these."""

    device: SubgraphBatch
    n_id: np.ndarray  # true (unpadded) global ids, IB first
    batch_size: int
    offset: np.ndarray  # [num_clusters_in_batch] int64
    count: np.ndarray
    num_edges: int = 0  # true (unpadded) edge count
    #: recorded on the copy stream after the batch's copies (CUDA only)
    staged: Optional[torch.cuda.Event] = None

    @property
    def num_nodes(self) -> int:
        return int(self.n_id.shape[0])

    def wait(self) -> "HostBatch":
        """Order the current stream after the batch's copies, and tell the
        caching allocator that the current stream uses its tensors (they
        were allocated on the copy stream).  A no-op off CUDA."""
        if self.staged is not None:
            stream = torch.cuda.current_stream(self.device.n_id.device)
            stream.wait_event(self.staged)
            for t in _tensors(self.device):
                t.record_stream(stream)
        return self


@dataclasses.dataclass
class PadBuckets:
    rows: int  # R_pad  (IB)
    cols: int  # C_pad  (IB + OB)
    edges: int  # E_pad
    k: int = 0  # ELL width, forward
    k_t: int = 0  # ELL width, transpose
    ovf: int = 0  # COO overflow pad, forward
    ovf_t: int = 0  # COO overflow pad, transpose
    nb: int = 0  # padded dense-tile count, forward
    nb_t: int = 0  # padded dense-tile count, transpose ('block' format)
    blk: int = 0  # per-block edge threshold: 0 undecided, -1 tier off
    rb: int = 128  # tile height ([rb, 128] tiles, chosen once)
    nnz: int = 0  # most dense-tier edges in one batch, forward
    nnz_t: int = 0  # the same, transpose ('block' format)

    def fits(self, r: int, c: int, e: int) -> bool:
        return r <= self.rows and c <= self.cols and e <= self.edges


def _round_up(x: int, align: int) -> int:
    return max(align, ((x + align - 1) // align) * align)


def _entry_bytes(nnz: int, rows: int, rb: int, itemsize: int) -> int:
    """Device bytes of a dense tier held as ``nnz`` tile-CSR entries over
    ``rows`` output rows: int32 columns, values, int32 row pointers."""
    return nnz * (4 + itemsize) + (_round_up(rows, rb) + 1) * 4


class SubgraphLoader:
    """Builds per-step subgraph batches from a cluster-permuted graph.

    ``ptr`` is the cluster slice pointer from ``partition_graph``;
    ``batch_size`` counts clusters per batch; ``mode`` selects the collate
    variant; ``num_neighbors`` caps each row in ``ns`` mode; ``device`` is
    where :meth:`to_device` puts the batch tensors."""

    def __init__(
        self,
        data: GraphData,
        ptr: np.ndarray,
        device,
        batch_size: int = 1,
        mode: str = "gas",
        num_neighbors: int = -1,
        shuffle: bool = False,
        seed: int = 0,
        bipartite: bool = True,
        trash_node: Optional[int] = None,
        align: int = 128,
        pad_slack: float = 1.1,
        adj_format: str = "hybrid",
        device_cache: Optional[bool] = None,
        static_groups: bool = False,
        log: bool = False,
        block_dtype=np.float32,
        block_d_hint: int = 256,
        block_force: bool = False,
        adj_perm: bool = False,
        global_cols: bool = False,
    ):
        """``adj_format``: 'coo' (padded edge list; edge dropout and the
        IB-only ablation), 'hybrid' (ELL+COO pair with the transpose
        backward, for training), 'hybrid-fwd' (forward-only), 'block'
        (dense tiles + remainder pair, for training) or 'block-fwd'
        (forward-only); the block formats fall back to the hybrid ones when
        the tier's cost model rejects a graph, unless ``block_force``.
        ``block_dtype``: tile dtype (``np.float32`` or ``ops.block.BF16``);
        ``block_d_hint``: the feature width the cost model assumes.
        ``static_groups``: with ``shuffle``, keep the cluster->batch grouping
        fixed and shuffle only the batch order.  ``adj_perm``: the 'hybrid'
        pairs carry the transpose slot permutation ``t2f`` (GAT's backward).
        ``global_cols``: a forward-only hybrid batch's ELL and overflow
        columns name rows of the ``[N+1, D]`` node table (``n_id`` of the
        batch-local column; padding the trash row ``N`` or a zero weight),
        so the refresh aggregates straight from the history caches
        (``models/base.py::_refresh_batch_global``); batches the dense tier
        builds keep their batch-local columns.  ``uses_global_cols`` says
        whether a collate remapped."""
        if mode not in ("gas", "ib", "ns"):
            raise ValueError(f"unknown loader mode {mode!r}")
        if adj_format not in ("coo", "hybrid", "hybrid-fwd", "block-fwd", "block"):
            raise ValueError(f"unknown adj_format {adj_format!r}")
        self.device = device
        self.adj_format = adj_format
        # an ns set is drawn anew every epoch: no fixed grouping to replay
        self.static_groups = static_groups and mode != "ns"
        self.block_dtype = block_dtype
        self.block_d_hint = block_d_hint
        self.block_force = block_force
        self.adj_perm = adj_perm
        self.global_cols = global_cols
        self.uses_global_cols = False  # set by the first remapped collate
        self.device_cache = device_cache
        self.data = data
        self.adj = data.adj_t
        self.ptr = np.asarray(ptr, dtype=np.int64)
        self.batch_size = batch_size
        self.mode = mode
        self.num_neighbors = num_neighbors
        self.shuffle = shuffle
        self.seed = seed
        self.bipartite = bipartite
        self.align = align
        self.pad_slack = pad_slack
        self.trash_node = data.num_nodes if trash_node is None else trash_node
        self.num_clusters = len(self.ptr) - 1
        self._epoch = 0
        self._cache: Optional[List[HostBatch]] = None
        #: a replayed training set too large for the device budget is
        #: collated anew on every pass instead of held on the host
        self._stream = False
        self.bucket_growths = 0  # bumped whenever buckets grow
        #: device-cache budget in bytes (the trainer sets it from the
        #: card's free memory); None = ``_DEFAULT_BUDGET``
        self.hbm_budget: Optional[int] = None
        #: batches a consumer holds staged ahead of the one it computes on
        #: (the trainer's prefetch depth), counted in the device budget
        self.in_flight = 0
        self._copy_stream: Optional[torch.cuda.Stream] = None

        groups = self._groups(shuffled=False)
        maxima = self._measure(groups)
        # static grouping => batch composition is deterministic: exact buckets
        slack = 1.0 if (not shuffle or self.static_groups
                        or (batch_size == 1 and mode != "ns")) else pad_slack
        self.buckets = PadBuckets(
            rows=_round_up(int(maxima[0] * slack), align),
            cols=_round_up(int(maxima[1] * slack), align),
            edges=_round_up(int(maxima[2] * slack), align),
        )
        if log:
            print(
                f"SubgraphLoader[{mode}]: {self.num_clusters} clusters, "
                f"{len(groups)} batches, buckets=(R={self.buckets.rows}, "
                f"C={self.buckets.cols}, E={self.buckets.edges})"
            )

    # ---------------- grouping ----------------
    def _groups(self, shuffled: bool, epoch: int = 0) -> List[np.ndarray]:
        """Group cluster ids into batches of ``batch_size`` clusters."""
        order = np.arange(self.num_clusters)
        if shuffled:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(order)
        return [
            order[i : i + self.batch_size]
            for i in range(0, self.num_clusters, self.batch_size)
        ]

    def _group_nodes(self, cluster_ids: np.ndarray):
        """IB node ids (concatenated cluster ranges) + offset/count metadata."""
        offs = self.ptr[cluster_ids]
        cnts = self.ptr[cluster_ids + 1] - offs
        idx = np.concatenate(
            [np.arange(o, o + c, dtype=np.int64) for o, c in zip(offs, cnts)]
        ) if len(cluster_ids) else np.empty(0, np.int64)
        return idx, offs, cnts

    def _measure(self, groups: Sequence[np.ndarray]):
        """Upper-bound (rows, cols, edges) per batch without relabeling:
        rows = IB count; edges <= sum of IB degrees; cols <= rows + edges."""
        max_r = max_c = max_e = 1
        deg = np.diff(self.adj.rowptr)
        for g in groups:
            offs = self.ptr[g]
            cnts = self.ptr[g + 1] - offs
            r = int(cnts.sum())
            e = int(sum(deg[o : o + c].sum() for o, c in zip(offs, cnts)))
            if self.mode == "ns" and self.num_neighbors >= 0:
                e = min(e, r * self.num_neighbors)
            c = r if self.mode == "ib" else min(self.data.num_nodes, r + e)
            max_r, max_c, max_e = max(max_r, r), max(max_c, c), max(max_e, e)
        return max_r, max_c, max_e

    # ---------------- collate ----------------
    def _collate(self, cluster_ids: np.ndarray, epoch: int = 0,
                 step: int = 0) -> HostBatch:
        """The batch of ``cluster_ids``; ``ns`` draws its sample from
        ``(seed, epoch, step)`` alone (the JAX loader's seed), so a pass
        collated on another thread, or after a resume, draws the same."""
        idx, offs, cnts = self._group_nodes(cluster_ids)
        bs = int(idx.shape[0])
        if self.mode == "ib":
            rowptr, col, value, n_id = relabel_one_hop_within_batch(
                self.adj, idx, self.bipartite)
        else:
            rowptr, col, value, n_id = relabel_one_hop(self.adj, idx, self.bipartite)
            if self.mode == "ns" and self.num_neighbors >= 0:
                rowptr, col, value = sample_neighbors(
                    rowptr, col, value, self.num_neighbors,
                    seed=hash((self.seed, epoch, step)) & 0x7FFFFFFF)
        tot = int(n_id.shape[0])
        r, e = bs, int(col.shape[0])
        if not self.buckets.fits(r, tot, e):
            self.buckets = PadBuckets(
                rows=max(self.buckets.rows, _round_up(int(r * self.pad_slack), self.align)),
                cols=max(self.buckets.cols, _round_up(int(tot * self.pad_slack), self.align)),
                edges=max(self.buckets.edges, _round_up(int(e * self.pad_slack), self.align)),
            )
            self.bucket_growths += 1

        b = self.buckets
        adj = self._build_adj(rowptr, col, value)
        n_id_pad = np.full(b.cols, self.trash_node, dtype=np.int64)
        n_id_pad[:tot] = n_id
        push_idx = np.full(b.rows, self.trash_node, dtype=np.int64)
        push_idx[:bs] = n_id[:bs]
        if self.global_cols and isinstance(adj, HybridAdj):
            # the remap rewrites the ELL and overflow columns only: extension
            # levels or incidence tiles would gather from batch-local rows
            assert not adj.ext and adj.ovf_inc is None, \
                "global columns need single-K loader builds"
            adj = adj._replace(ell_cols=n_id_pad[adj.ell_cols].astype(np.int32),
                               ovf_cols=n_id_pad[adj.ovf_cols].astype(np.int32))
            self.uses_global_cols = True
        device = SubgraphBatch(adj=adj, n_id=n_id_pad, push_idx=push_idx,
                               batch_size=bs, num_nodes=tot)
        return HostBatch(device=device, n_id=n_id, batch_size=bs, offset=offs,
                         count=cnts, num_edges=e)

    def _build_adj(self, rowptr, col, value):
        """Build the adjacency in the configured format, keeping static
        hybrid buckets (ELL width / overflow size) across batches."""
        b = self.buckets
        if self.adj_format == "coo":
            return build_padded_adj(rowptr, col, value, b.rows, b.cols, b.edges)
        if self.adj_format in ("block-fwd", "block"):
            blk = self._build_block_adj(rowptr, col, value,
                                        bi=self.adj_format == "block")
            if blk is not None:
                return blk
            # tier rejected for this graph -> plain hybrid below

        deg = np.diff(rowptr)
        tdeg = np.bincount(col, minlength=b.cols) if col.size else np.zeros(1, np.int64)
        k, ovf = ell_buckets([deg], k=b.k, ovf=b.ovf)
        k_t, ovf_t = ell_buckets([tdeg], k=b.k_t, ovf=b.ovf_t)
        if (k, ovf, k_t, ovf_t) != (b.k, b.ovf, b.k_t, b.ovf_t):
            b.k, b.ovf, b.k_t, b.ovf_t = k, ovf, k_t, ovf_t
            self.bucket_growths += 1

        if self.adj_format in ("hybrid-fwd", "block-fwd"):
            return build_hybrid_adj(rowptr, col, value, b.rows, b.cols,
                                    k=b.k, ovf_pad=b.ovf)
        return build_bi_hybrid_adj(rowptr, col, value, b.rows, b.cols,
                                   k=b.k, k_t=b.k_t, ovf_pad=b.ovf,
                                   ovf_pad_t=b.ovf_t, with_perm=self.adj_perm)

    def _budget(self) -> int:
        return self.hbm_budget if self.hbm_budget is not None else _DEFAULT_BUDGET

    def _build_block_adj(self, rowptr, col, value, bi: bool = False):
        """Dense-tier build for 'block-fwd' / 'block' (forward + exact
        transpose pair).  Decides on the first collate whether the tier pays
        — cost model plus "tiles must fit the device cache", retrying
        shorter tiles (rb 512 -> 256 -> 128) on a residency miss — then
        keeps static tile buckets.  Returns None when the tier is off."""
        b = self.buckets
        a_itemsize = _tile_itemsize(self.block_dtype)
        measured = None  # (thresh, total, rem_deg) of the last measure pass
        if b.blk == 0:  # decide on the first collated batch
            # the tier only pays when batches are collated once and replayed
            replayable = (not self.shuffle or self.static_groups
                          or (self.batch_size == 1 and self.mode != "ns"))
            if not replayable and not self.block_force:
                b.blk = -1
                return None
            plan = plan_block_tier_rb(
                rowptr, col, b.cols, x_itemsize=a_itemsize,
                a_itemsize=a_itemsize, d_hint=self.block_d_hint)
            th = None
            if plan is not None:
                th, b.rb = plan
            elif self.block_force:
                th = marginal_thresh(a_itemsize, a_itemsize, self.block_d_hint)
            why = "cost model: hybrid within min_gain"
            if th is not None:
                for rb_try in [r for r in (b.rb, 256, 128) if r <= b.rb]:
                    plan_try = (th, rb_try) if rb_try == b.rb else \
                        plan_block_tier_rb(
                            rowptr, col, b.cols, x_itemsize=a_itemsize,
                            a_itemsize=a_itemsize, d_hint=self.block_d_hint,
                            rb_candidates=(rb_try,))
                    if plan_try is None:
                        continue
                    th_try, rb_try = plan_try
                    total, rem_deg = measure_block_tier(
                        rowptr, col, b.rows, b.cols, th_try, rb_rows=rb_try)
                    k_est = choose_k(rem_deg)
                    # the tiles ride as their nonzeros (at most one entry
                    # per dense edge), not as their cells
                    per = (_entry_bytes(col.size - int(rem_deg.sum()),
                                        b.rows, rb_try, a_itemsize)
                           + b.rows * k_est * 8 + (b.rows + b.cols) * 4
                           + int(np.maximum(rem_deg - k_est, 0).sum()) * 12)
                    if bi:  # the transpose pair roughly doubles the bytes
                        per *= 2
                    if self.block_force or per * len(self) <= self._budget():
                        th, b.rb = th_try, rb_try
                        measured = (th, total, rem_deg)
                        break
                    why = (f"residency budget: ~{per * len(self) >> 20} MB"
                           f" of tiles+batch over {self._budget() >> 20} MB "
                           f"(rb={rb_try})")
                    th = None
                else:
                    th = None
            b.blk = th if th is not None else -1
            log.info("block tier %s (%s)", "ON" if b.blk > 0 else "off",
                     f"thresh={b.blk}" if b.blk > 0 else why)
        if b.blk < 0:
            return None

        if measured is not None and measured[0] == b.blk:
            total, rem_deg = measured[1], measured[2]
        else:
            total, rem_deg = measure_block_tier(rowptr, col, b.rows, b.cols,
                                                b.blk, rb_rows=b.rb)
        # forward-only remainders use the overflow-locality kink; training
        # pairs size without it (ops/ell.choose_k)
        b.k, b.ovf, grew = _grow(ell_buckets([rem_deg], k=b.k, ovf=b.ovf,
                                             locality_kink=not bi),
                                 b.k, b.ovf)
        if total > b.nb:
            b.nb, grew = total, True
        # the tile entries are padded to the most any batch has (one shape
        # for every batch, as the JAX package's static tile list)
        nnz = col.size - int(rem_deg.sum())
        if nnz > b.nnz:
            b.nnz, grew = nnz, True
        if not bi:
            if grew:
                self.bucket_growths += 1
            return build_block_hybrid(
                rowptr, col, value, b.rows, b.cols, thresh=b.blk,
                a_dtype=self.block_dtype, k=b.k, ovf_pad=b.ovf, nb_pad=b.nb,
                rb_rows=b.rb, nnz_pad=b.nnz)

        # transpose buckets, measured on the actual transpose
        transpose = transpose_csr_host(rowptr, col, value, b.cols)
        total_t, rem_deg_t = measure_block_tier(transpose[0], transpose[1],
                                                b.cols, b.rows, b.blk,
                                                rb_rows=b.rb)
        b.k_t, b.ovf_t, grew_t = _grow(
            ell_buckets([rem_deg_t], k=b.k_t, ovf=b.ovf_t,
                        locality_kink=False), b.k_t, b.ovf_t)
        grew = grew or grew_t
        nnz_t = col.size - int(rem_deg_t.sum())
        if nnz_t > b.nnz_t:
            b.nnz_t, grew = nnz_t, True
        if total_t > b.nb_t:
            b.nb_t, grew = total_t, True
        if grew:
            self.bucket_growths += 1
        return build_bi_block_hybrid(
            rowptr, col, value, b.rows, b.cols, thresh=b.blk,
            a_dtype=self.block_dtype, k=b.k, k_t=b.k_t, ovf_pad=b.ovf,
            ovf_pad_t=b.ovf_t, nb_pad=b.nb, nb_pad_t=b.nb_t,
            transpose=transpose, rb_rows=b.rb, nnz_pad=b.nnz, nnz_pad_t=b.nnz_t)

    def dense_tiles(self) -> int:
        """Dense tiles holding at least one edge over the cached batches
        (forward halves; 0 when the tier is off or nothing is cached)."""
        n = 0
        for hb in self._cache or ():
            adj = getattr(hb.device.adj, "fwd", hb.device.adj)
            if hasattr(adj, "dense"):
                n += nonempty_tiles(adj.dense)
        return n

    # ---------------- iteration ----------------
    def __len__(self) -> int:
        return -(-self.num_clusters // self.batch_size)

    def to_device(self, hb: HostBatch) -> HostBatch:
        """The batch on the loader's device.  On CUDA: pinned host copies
        sent ``non_blocking`` on the loader's copy stream, then an event
        (``HostBatch.staged``) that the consumer waits on."""
        if not isinstance(hb.device.n_id, np.ndarray):
            return hb
        device = torch.device(self.device)
        if device.type != "cuda":
            return dataclasses.replace(hb, device=hb.device.to(device))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._copy_stream):
            staged = hb.device.to(device, pinned=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dataclasses.replace(hb, device=staged, staged=event)

    def _use_device_cache(self) -> bool:
        """Keep the collated batches on the device while they fit the
        budget; larger sets are staged anew on each pass."""
        if self.device_cache is not None:
            return self.device_cache
        b = self.buckets
        per = (b.rows + b.cols) * 8 + b.edges * 12 + b.rows * (b.k + b.k_t) * 8
        if b.blk > 0:  # the dense tier's nonzeros ride along with each batch
            itemsize = _tile_itemsize(self.block_dtype)
            per += (_entry_bytes(b.nnz, b.rows, b.rb, itemsize)
                    + _entry_bytes(b.nnz_t, b.cols, b.rb, itemsize))
        return per * (len(self) + self.in_flight) < self._budget()

    def _materialize_cache(self):
        """Collate the deterministic groups once; if a pad bucket grew
        mid-pass, re-collate the whole set under the final buckets so every
        cached batch shares one shape (bucket growth is monotone, so the
        second pass is stable).

        A training loader (``shuffle``) whose collated batches outgrow the
        device budget (projected from the batches collated so far) stops
        here and streams instead.  Such a set could only be held on the
        host and restaged every epoch, and at products degree its dense
        tiles run to tens of GB, more than the host may have; a training
        pass visits each batch once, so collating it anew costs one collate
        per batch and epoch.  The JAX package holds it on the host; the
        batches are the same either way."""
        groups = self._groups(shuffled=False)
        before = self.bucket_growths
        cache, held = [], 0
        for i, g in enumerate(groups):
            cache.append(self._collate(g, 0, i))
            held += _host_bytes(cache[-1].device)
            projected = held * (len(groups) + self.in_flight) // len(cache)
            if self.shuffle and self.device_cache is None and projected > self._budget():
                log.info("batch set: streamed (~%d MB projected over a %d MB "
                         "device budget)", projected >> 20, self._budget() >> 20)
                self._stream = True
                return
        if self.bucket_growths != before:
            cache.clear()  # free the stale batches before the second pass
            cache.extend(self._collate(g, 0, i) for i, g in enumerate(groups))
        on_device = self._use_device_cache()
        if on_device:
            for i, hb in enumerate(cache):  # each host copy freed as it moves
                cache[i] = self.to_device(hb)
        log.info("batch set: %d batches cached on the %s", len(cache),
                 "device" if on_device else "host (staged on every pass)")
        self._cache = cache

    def cached(self, subset: Optional[Sequence[int]] = None) -> List[HostBatch]:
        """The deterministic batch set as it is held (on the device, or on
        the host to be staged with :meth:`to_device`), collated on first
        use; ``subset`` picks batches by index."""
        assert not self.shuffle, "a shuffled set is collated per pass"
        if self._cache is None:
            self._materialize_cache()
        return self._cache if subset is None else [self._cache[i] for i in subset]

    def __iter__(self) -> Iterator[HostBatch]:
        if not self.shuffle:
            for hb in self.cached():
                yield self.to_device(hb)
            return
        epoch = self._epoch
        self._epoch += 1
        # single-cluster batches (or static groups) with no resampling:
        # shuffling only permutes the batch ORDER — collate once, cache,
        # replay in shuffled order
        if (self.batch_size == 1 or self.static_groups) and self.mode != "ns":
            if self._cache is None and not self._stream:
                self._materialize_cache()
            groups = self._groups(shuffled=False)
            order = np.random.default_rng((self.seed, epoch)).permutation(
                len(groups))
            for k in order:
                yield self.to_device(self._collate(groups[k]) if self._stream
                                      else self._cache[k])
            return
        for step, g in enumerate(self._groups(shuffled=True, epoch=epoch)):
            yield self.to_device(self._collate(g, epoch, step))


class EvalSubgraphLoader(SubgraphLoader):
    """Deterministic, precomputed loader for layer-wise inference / cache
    refresh (reference: loader.py:266-284): coarsens ``ptr`` by
    ``batch_size`` clusters per batch, then iterates each batch once."""

    def __init__(self, data: GraphData, ptr: np.ndarray, device,
                 batch_size: int = 1, bipartite: bool = True, **kwargs):
        ptr = np.asarray(ptr, dtype=np.int64)
        coarse = ptr[::batch_size]
        if coarse[-1] != data.num_nodes:
            coarse = np.concatenate([coarse, [data.num_nodes]])
        super().__init__(data, coarse, device, batch_size=1, mode="gas",
                         shuffle=False, bipartite=bipartite, **kwargs)
