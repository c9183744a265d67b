"""Device-sharded node layout: clusters → device slabs.

A numpy-only copy of ``incagg_gnn_tpu/parallel/layout.py`` (the port
imports nothing of the JAX package), held bit for bit to it by
``tests/test_torch_layout.py``.  Clusters are bin-packed onto devices
(ranks); each device owns a fixed-size *slab* of node rows holding its
clusters contiguously, padded to a common slab size with a per-slab trash
row at the end.  Global row ``r`` lives on device ``r // slab`` at local
row ``r % slab``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ShardLayout:
    n_dev: int
    slab: int  # rows per device, incl. the trailing trash row
    dev_of_cluster: np.ndarray  # [num_clusters] device owning each cluster
    cluster_row: np.ndarray  # [num_clusters] new-layout start row of cluster
    node_to_row: np.ndarray  # [N] old (permuted) node id -> new global row
    row_to_node: np.ndarray  # [n_dev*slab] new row -> old node id, -1 for pad/trash

    @property
    def num_rows(self) -> int:
        return self.n_dev * self.slab

    def local_trash(self) -> int:
        """Local (in-slab) index of the trash row."""
        return self.slab - 1


def build_shard_layout(ptr: np.ndarray, n_dev: int, align: int = 8) -> ShardLayout:
    """Greedy bin-packing of clusters (largest-first onto least-loaded device)
    and construction of the slab row layout."""
    ptr = np.asarray(ptr, dtype=np.int64)
    sizes = np.diff(ptr)
    k = len(sizes)
    order = np.argsort(-sizes, kind="stable")
    load = np.zeros(n_dev, dtype=np.int64)
    dev_of_cluster = np.zeros(k, dtype=np.int64)
    for c in order:
        d = int(load.argmin())
        dev_of_cluster[c] = d
        load[d] += sizes[c]
    return _layout_from_assignment(ptr, dev_of_cluster, n_dev, align)


def cluster_affinity(rowptr: np.ndarray, col: np.ndarray,
                     ptr: np.ndarray) -> np.ndarray:
    """Symmetric [K, K] inter-cluster edge-count matrix (diagonal zeroed) —
    the coarsened cluster graph used for hierarchy-aware placement."""
    ptr = np.asarray(ptr, dtype=np.int64)
    k = len(ptr) - 1
    deg = np.diff(np.asarray(rowptr, dtype=np.int64))
    c_of = np.repeat(np.arange(k), np.diff(ptr))  # node -> cluster
    rows_c = np.repeat(c_of, deg)
    cols_c = c_of[np.asarray(col, dtype=np.int64)]
    # bincount, not np.add.at: the unbuffered ufunc path is ~50x slower and
    # this runs over every edge at sharded-trainer startup
    w = np.bincount(rows_c * k + cols_c, minlength=k * k).astype(np.int64)
    w = w.reshape(k, k)
    w = w + w.T
    np.fill_diagonal(w, 0)
    return w


def build_shard_layout_hierarchical(
    ptr: np.ndarray,
    rowptr: np.ndarray,
    col: np.ndarray,
    n_hosts: int,
    chips_per_host: int,
    align: int = 8,
    balance_slack: float = 0.05,
) -> ShardLayout:
    """Two-level cluster placement for a (hosts × chips) mesh.  Two
    candidates are built over the coarsened cluster-affinity graph and the
    one with the lower DCN-weighted cut (cross-host edges x10 + intra-host
    cross-device edges) wins:

    * top-down: clusters -> hosts by affinity-greedy + FM refinement, then
      the same partitioner packs each host's clusters onto its chips;
    * bottom-up: flat affinity packing onto all ``n_dev`` devices, then the
      DEVICES are grouped into hosts by max intra-host device affinity
      (SCALING_r05 measured the flat packer's per-device locality beating
      the top-down split at 2x4 — intra-device locality is harder to
      recover after a host split than host locality is to recover from a
      good device packing).

    Device index =
    ``host * chips_per_host + chip`` — host-major, matching the flattened
    order of a 2-D ``Mesh(devices.reshape(hosts, chips), ("host", "chip"))``
    and the lexicographic device order of tuple-axis collectives.

    The single-level packer treats all device pairs as equidistant; on real
    pods DCN bandwidth per host is ~10x below ICI, so cross-host halo bytes
    are the scaling limiter (SURVEY §7 step 9).

    Cluster COUNTS are also capped per host at ``ceil(k / n_dev) *
    chips_per_host`` (per-DEVICE rounds x chips — chosen so the per-device
    round count stays optimal after level-2 packing; can exceed a naive
    ``ceil(k / n_hosts)`` host split) and per chip within a host at
    ``ceil(k / n_dev)``: the sharded trainers run ``max(batches per
    device)`` rounds of identically-padded steps, so one over-counted
    device inflates every epoch by a whole padded round — count imbalance
    is pure sharding overhead (SCALING_r03's measured 21.6% binding term).
    Affinity swaps are 1-for-1 and preserve counts."""
    ptr = np.asarray(ptr, dtype=np.int64)
    sizes = np.diff(ptr)
    k = len(sizes)
    n_dev = n_hosts * chips_per_host
    w = cluster_affinity(rowptr, col, ptr)

    # ---- candidate A: top-down — clusters -> hosts, then affinity-packed
    # onto each host's chips (both levels use the greedy+FM partitioner) --
    cap1 = int(np.ceil(sizes.sum() / n_hosts * (1.0 + balance_slack)))
    ccap1 = int(np.ceil(k / n_dev)) * chips_per_host
    host_of = _affinity_partition(sizes, w, n_hosts, cap1, ccap1)
    dev_a = np.zeros(k, dtype=np.int64)
    for h in range(n_hosts):
        mine = np.nonzero(host_of == h)[0]
        if len(mine) == 0:
            continue
        dcap = int(np.ceil(len(mine) / chips_per_host))
        scap = int(np.ceil(sizes[mine].sum() / chips_per_host
                           * (1.0 + balance_slack)))
        sub = _affinity_partition(sizes[mine], w[np.ix_(mine, mine)],
                                  chips_per_host, scap, dcap)
        dev_a[mine] = h * chips_per_host + sub
    if chips_per_host == 1 or n_hosts == 1:
        return _layout_from_assignment(ptr, dev_a, n_dev, align)

    # ---- candidate B: bottom-up — flat affinity over all devices, then
    # group the DEVICES into hosts by max intra-host device affinity
    # (SCALING_r05 measured the flat packer beating top-down grouping at
    # 2x4: per-device locality is harder to recover after a host split
    # than host locality is to recover from a good device packing) ------
    capd = int(np.ceil(sizes.sum() / n_dev * (1.0 + balance_slack)))
    ccapd = int(np.ceil(k / n_dev))
    dev_flat = _affinity_partition(sizes, w, n_dev, capd, ccapd)
    dw = _device_affinity(dev_flat, w, n_dev)
    group_of_dev = _affinity_partition(
        np.ones(n_dev, dtype=np.int64), dw, n_hosts,
        cap=chips_per_host, ccap=chips_per_host)
    rank = np.zeros(n_dev, dtype=np.int64)
    for g in range(n_hosts):
        mem = np.nonzero(group_of_dev == g)[0]
        rank[mem] = g * chips_per_host + np.arange(len(mem))
    dev_b = rank[dev_flat]

    # ---- pick by DCN-weighted cut: cross-host edges ride DCN (~10x
    # slower than ICI), intra-host cross-device edges ride ICI ----------
    def _score(dev_of):
        m = _device_affinity(dev_of, w, n_dev)
        host = np.arange(n_dev) // chips_per_host
        same_host = host[:, None] == host[None, :]
        intra_host = m[same_host].sum() - np.trace(m)
        cross_host = m.sum() - np.trace(m) - intra_host
        return 10.0 * cross_host + intra_host

    dev_of_cluster = dev_a if _score(dev_a) <= _score(dev_b) else dev_b
    return _layout_from_assignment(ptr, dev_of_cluster, n_dev, align)


def _device_affinity(dev_of: np.ndarray, w: np.ndarray,
                     n_dev: int) -> np.ndarray:
    """Coarsen the cluster-affinity matrix to a [n_dev, n_dev] device
    affinity (inter-device edge counts; diagonal = intra-device)."""
    m = np.zeros((n_dev, n_dev), dtype=np.int64)
    for d in range(n_dev):
        wd = w[dev_of == d].sum(axis=0)
        m[d] = np.bincount(dev_of, weights=wd, minlength=n_dev)
    return m


def _affinity_partition(sizes: np.ndarray, w: np.ndarray, n_groups: int,
                        cap: int, ccap: int, rounds: int = 8) -> np.ndarray:
    """Affinity-greedy growing + FM refinement: partition items with
    ``sizes`` and affinity matrix ``w`` into ``n_groups`` groups under a
    size cap ``cap`` and a count cap ``ccap``, maximizing intra-group
    affinity.  Returns ``group_of [k]``.  (The shared engine behind both
    levels of the hierarchical layout and the device->host grouping.)"""
    k = len(sizes)
    group_of = np.full(k, -1, dtype=np.int64)
    load = np.zeros(n_groups, dtype=np.int64)
    cnt = np.zeros(n_groups, dtype=np.int64)
    # affinity[c, g] = edges between item c and group g's current set
    aff = np.zeros((k, n_groups), dtype=np.int64)
    order = np.argsort(-sizes, kind="stable")
    for c in order:
        open_g = np.nonzero((load + sizes[c] <= cap) & (cnt < ccap))[0]
        if len(open_g) == 0:
            open_g = np.nonzero(cnt < ccap)[0]
        if len(open_g) == 0:
            open_g = np.array([int(load.argmin())])
        # prefer the open group with max affinity; tie-break on least load
        a = aff[c, open_g]
        best = open_g[np.lexsort((load[open_g], -a))][0]
        group_of[c] = best
        load[best] += sizes[c]
        cnt[best] += 1
        aff[:, best] += w[:, c]
    # the greedy is order-degenerate (an empty group has zero affinity, so
    # the first group fills to its cap before the rest see anything);
    # FM-style sweeps — single moves, then pairwise swaps (which keep
    # working when every group sits at the balance cap and no single move
    # is feasible) — until no step improves the cut
    def _move(c, g_from, g_to):
        group_of[c] = g_to
        load[g_from] -= sizes[c]
        load[g_to] += sizes[c]
        cnt[g_from] -= 1
        cnt[g_to] += 1
        aff[:, g_from] -= w[:, c]
        aff[:, g_to] += w[:, c]

    idx = np.arange(k)
    for _ in range(rounds):
        changed = 0
        for c in order:
            g = int(group_of[c])
            gains = aff[c] - aff[c, g]
            gains[(load + sizes[c] > cap) | (cnt >= ccap)] = -1  # caps
            gains[g] = 0
            b = int(gains.argmax())
            if gains[b] > 0:
                _move(c, g, b)
                changed += 1
        for c in range(k):
            g1 = int(group_of[c])
            g_c = aff[c] - aff[c, g1]  # c's gain moving to each group
            g2s = group_of
            # swap gain with each c2: both move; their mutual edges stay cut
            tot = (g_c[g2s] + (aff[idx, g1] - aff[idx, g2s]) - 2 * w[c])
            feas = ((load[g1] - sizes[c] + sizes <= cap)
                    & (load[g2s] - sizes + sizes[c] <= cap)
                    & (g2s != g1))
            tot = np.where(feas, tot, 0)
            c2 = int(tot.argmax())
            if tot[c2] > 0:
                g2 = int(group_of[c2])
                _move(c, g1, g2)
                _move(c2, g2, g1)
                changed += 1
        if changed == 0:
            break
    return group_of


def edge_locality(layout: ShardLayout, rowptr: np.ndarray, col: np.ndarray,
                  ptr: np.ndarray, chips_per_host: int) -> dict:
    """Fraction of graph edges that are intra-device / intra-host (ICI) /
    cross-host (DCN) under a layout — the halo-traffic diagnostic."""
    ptr = np.asarray(ptr, dtype=np.int64)
    k = len(ptr) - 1
    c_of = np.repeat(np.arange(k), np.diff(ptr))
    deg = np.diff(np.asarray(rowptr, dtype=np.int64))
    d_src = layout.dev_of_cluster[np.repeat(c_of, deg)]
    d_dst = layout.dev_of_cluster[c_of[np.asarray(col, dtype=np.int64)]]
    e = len(d_src)
    same_dev = (d_src == d_dst).sum()
    same_host = (d_src // chips_per_host == d_dst // chips_per_host).sum()
    return {
        "intra_device": same_dev / e,
        "intra_host": (same_host - same_dev) / e,
        "cross_host": (e - same_host) / e,
    }


def _layout_from_assignment(ptr: np.ndarray, dev_of_cluster: np.ndarray,
                            n_dev: int, align: int) -> ShardLayout:
    sizes = np.diff(ptr)
    k = len(sizes)
    load = np.zeros(n_dev, dtype=np.int64)
    np.add.at(load, dev_of_cluster, sizes)
    slab = int(load.max()) + 1  # +1 trash row
    slab = ((slab + align - 1) // align) * align

    n = int(ptr[-1])
    node_to_row = np.empty(n, dtype=np.int64)
    row_to_node = np.full(n_dev * slab, -1, dtype=np.int64)
    cluster_row = np.zeros(k, dtype=np.int64)
    cursor = np.arange(n_dev, dtype=np.int64) * slab
    for c in range(k):  # keep cluster order stable within each device
        d = dev_of_cluster[c]
        start, size = int(ptr[c]), int(sizes[c])
        cluster_row[c] = cursor[d]
        rows = np.arange(cursor[d], cursor[d] + size)
        node_to_row[start : start + size] = rows
        row_to_node[rows] = np.arange(start, start + size)
        cursor[d] += size
    return ShardLayout(
        n_dev=n_dev,
        slab=slab,
        dev_of_cluster=dev_of_cluster,
        cluster_row=cluster_row,
        node_to_row=node_to_row,
        row_to_node=row_to_node,
    )


def scatter_table(layout: ShardLayout, table: np.ndarray, fill=0) -> np.ndarray:
    """Re-lay a [N, ...] node table into the [n_dev*slab, ...] shard layout
    (pad/trash rows get ``fill``)."""
    out_shape = (layout.num_rows,) + table.shape[1:]
    out = np.full(out_shape, fill, dtype=table.dtype)
    valid = layout.row_to_node >= 0
    out[valid] = table[layout.row_to_node[valid]]
    return out
