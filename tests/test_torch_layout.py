"""The port's slab layout and sharded host plan (``parallel/layout.py``,
``parallel/plan.py``) against the JAX package's: ``build_shard_layout``,
``build_shard_layout_hierarchical``, ``edge_locality`` and
``scatter_table`` bit for bit, flat and ``2 x 2``; and for 4 devices the
halo plans, pads, format buckets and packed batches of every round equal
a JAX ``ShardedVRTrainer``'s on the conftest's virtual CPU mesh (GCN
hybrid Reverb and GAS, GCNII block Reverb; GCN GAS on a ``2 x 2`` mesh;
GAT Reverb on the hybrid pair with its transpose slot permutation ``t2f``,
and GAT GAS on COO).  Nothing is spawned and no step is compiled."""

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph import csr as J_csr
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.models import GAT as JGAT
from incagg_gnn_tpu.models import GATConfig as JGATConfig
from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCN2 as JGCN2
from incagg_gnn_tpu.models import GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.parallel import layout as J_lay
from incagg_gnn_tpu.parallel.mesh import make_mesh, make_mesh_2d
from incagg_gnn_tpu.parallel.spatial import ShardedVRTrainer as JSharded
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.parallel import layout as T_lay
from incagg_gnn_tpu_torch.parallel.plan import PlanConfig, build_plan, collate_round
from incagg_gnn_tpu_torch.train.trainer import TrainerConfig
from test_torch_host import assert_same_tree
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(1)


def _normalized(data, parts: int, seed: int = 0):
    """The JAX trainer's partition / permute / self-loops / gcn_norm."""
    perm, ptr = J_part.partition_graph(data.adj_t, parts, seed=seed)
    d = J_csr.permute(data, perm)
    d.adj_t = J_csr.gcn_norm(d.adj_t.set_diag(), add_self_loops=False)
    return d, ptr


def _same_layout(j, t):
    assert (j.n_dev, j.slab) == (t.n_dev, t.slab)
    for f in ("dev_of_cluster", "cluster_row", "node_to_row", "row_to_node"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("parts,hosts,chips", [(8, 1, 4), (16, 1, 4), (16, 2, 2), (8, 2, 2)])
def test_layouts_equal_the_jax_package(sbm_small, parts, hosts, chips):
    data, _, _ = sbm_small
    d, ptr = _normalized(data, parts)
    adj = d.adj_t
    n_dev = hosts * chips
    _same_layout(J_lay.build_shard_layout(ptr, n_dev), T_lay.build_shard_layout(ptr, n_dev))
    assert np.array_equal(J_lay.cluster_affinity(adj.rowptr, adj.col, ptr),
                          T_lay.cluster_affinity(adj.rowptr, adj.col, ptr))
    jl = J_lay.build_shard_layout_hierarchical(ptr, adj.rowptr, adj.col, hosts * (
        chips if hosts == 1 else 1), 1 if hosts == 1 else chips)
    tl = T_lay.build_shard_layout_hierarchical(ptr, adj.rowptr, adj.col, hosts * (
        chips if hosts == 1 else 1), 1 if hosts == 1 else chips)
    _same_layout(jl, tl)
    assert (J_lay.edge_locality(jl, adj.rowptr, adj.col, ptr, chips)
            == T_lay.edge_locality(tl, adj.rowptr, adj.col, ptr, chips))
    for table, fill in ((d.x, 0), (d.train_mask, False), (d.y, 0)):
        a, b = J_lay.scatter_table(jl, table, fill), T_lay.scatter_table(tl, table, fill)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _port_data(d):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(d.adj_t.rowptr, d.adj_t.col, d.adj_t.value),
        x=d.x, y=d.y, train_mask=d.train_mask, val_mask=d.val_mask, test_mask=d.test_mask)


CASES = {
    "gcn-hybrid-vr": ("GCN", dict(adj_format="hybrid", vr_update=True)),
    "gcn-hybrid-gas": ("GCN", dict(adj_format="hybrid", vr_update=False)),
    "gcn2-block-vr": ("GCN2", dict(adj_format="block", vr_update=True)),
    # a (2 hosts x 2 chips) mesh: the hierarchical layout
    "gcn-hybrid-gas-2x2": ("GCN", dict(adj_format="hybrid", vr_update=False)),
    # GAT: Reverb on the hybrid pair with t2f, GAS on COO (JAX spatial.py:262-274)
    "gat-hybrid-vr": ("GAT", dict(adj_format="auto", vr_update=True)),
    "gat-coo-gas": ("GAT", dict(adj_format="auto", vr_update=False)),
}
#: (eval, train) formats of each case
FORMATS = {"gcn-hybrid-vr": ("fwd", "bi"), "gcn-hybrid-gas": ("fwd", "bi"),
           "gcn2-block-vr": ("block", "bi-block"), "gcn-hybrid-gas-2x2": ("fwd", "bi"),
           "gat-hybrid-vr": ("fwd", "bi"), "gat-coo-gas": ("coo", "coo")}


def _jax_model(name, arch):
    if name == "GAT":
        return JGAT(JGATConfig(**arch, hidden_heads=2))
    return JGCN(JGCNConfig(**arch)) if name == "GCN" else JGCN2(JGCN2Config(**arch))


@pytest.mark.parametrize("case", list(CASES))
def test_plans_equal_the_jax_sharded_trainer(sbm_small, case):
    """Every round's halo plan, the halo width, and each device's packed
    batch (``n_id`` in global rows, ``push_idx`` in local rows, the
    adjacency in the set's format and buckets) equal the JAX trainer's."""
    data, in_c, out_c = sbm_small
    name, fmt = CASES[case]
    kw = dict(num_parts=8, batch_size=1, seed=0, **fmt)
    arch = dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=16,
                out_channels=out_c, num_layers=2, dropout=0.0, drop_input=False)
    if name == "GAT":
        arch.pop("drop_input")
    jmodel = _jax_model(name, arch)
    hosts = 2 if case.endswith("2x2") else 1
    mesh = make_mesh_2d(2, 2) if hosts == 2 else make_mesh(4)
    jt = JSharded(jmodel, data, JTrainerConfig(**kw), mesh=mesh)

    d, ptr = _normalized(data, 8)
    tdata = _port_data(d)
    plan = build_plan(tdata.adj_t, ptr, PlanConfig.of(name, TrainerConfig(**kw),
                                                      jmodel.hist_dim), 4, n_hosts=hosts)
    _same_layout(jt.layout, plan.layout)
    assert plan.train.rounds == jt._train_rounds and plan.eval.rounds == jt._eval_rounds
    sets = [("eval", plan.eval, jt._eval_stacks, jt._halo_plans)]
    if kw["vr_update"]:
        sets.append(("train", plan.train, jt._train_stacks, None))
        assert plan.train.round_edges == jt._train_round_edges
    else:
        sets.append(("train", plan.train, jt._train_stacks, jt._train_halos))
    assert (plan.eval.fmt, plan.train.fmt) == FORMATS[case]
    if name == "GAT":
        assert plan.adj_format == jt.adj_format
        if kw["vr_update"]:
            assert jt._adj_perm and plan.train.fmt_args["with_perm"]
    for tag, sp, stacks, halos in sets:
        for i in range(sp.rounds):
            stack = jax.tree.map(np.asarray, stacks[i])
            for dev in range(4):
                if halos is not None:
                    jh = jax.tree.map(lambda a: np.asarray(a)[dev], halos[i])
                    th = sp.halos[i][dev]
                    for f in jh._fields:
                        a, b = getattr(jh, f), getattr(th, f)
                        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, i, dev, f)
                jb = jax.tree.map(lambda a: a[dev], stack)
                tb = collate_round(tdata.adj_t, ptr, plan, sp, dev, i)
                assert np.array_equal(jb.n_id, tb.n_id), (tag, i, dev)
                assert np.array_equal(jb.push_idx, tb.push_idx), (tag, i, dev)
                assert (int(jb.batch_size), int(jb.num_nodes)) == (tb.batch_size,
                                                                    tb.num_nodes)
                # the JAX package trains GAS on the forward half alone
                gas_bi = tag == "train" and not kw["vr_update"] and sp.fmt == "bi"
                tadj = tb.adj.fwd if gas_bi else tb.adj
                assert_same_tree(jb.adj, tadj, f"{tag}[{i}][{dev}].adj")
                if tag == "train" and name == "GAT" and sp.fmt == "bi":
                    assert tb.adj.t2f is not None and np.array_equal(jb.adj.t2f,
                                                                      tb.adj.t2f)
    assert plan.eval.halo_width == np.asarray(jt._halo_plans[0].send_idx).shape[2]
