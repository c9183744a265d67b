"""The port's mesh ``Trainer`` (``Trainer(..., mesh=mesh)``: one program on
every rank over row-sharded caches and tables, ``parallel/rows.py``), four
gloo ranks on the CPU spawned once for the module through
``parallel/launch.py::run_mesh_trainer``, at the configuration of the JAX
package's own ``tests/test_sharded_gas.py`` (GCN on ``sbm_small``, 8 parts,
2 clusters a batch, hidden 24, 2 layers, dropout 0):

- GAS and Reverb: the fill logits, one epoch's loss and the parameters
  equal the port's unsharded ``Trainer`` (on the same formats) bit for bit,
  and lie within that JAX test's bounds (``atol=2e-3, rtol=1e-3``) of JAX
  ``Trainer(mesh=make_mesh(4))`` from the same parameters, val accuracy
  within 0.05; every rank holds ``rows_pad / 4`` rows of each cache and
  table;
- GAT (on the hybrid pair with its transpose slot permutation), GCNII,
  GraphSAGE, APPNP and PNA_JK under the mesh equal their unsharded runs;
- a checkpoint written under the mesh restores into the unsharded trainer;
- the format policy under a mesh (no dense tier, ``adj_format=block``
  refused, no global columns), a 2-D mesh's slabs (``rows_pad / n_hosts``
  rows; ``tests/test_torch_mesh2d.py`` runs one) and the spill tier's
  refusal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.parallel.mesh import make_mesh
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel.launch import run_mesh_trainer
from incagg_gnn_tpu_torch.parallel.rows import rows_pad
from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig, choose_formats
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(1)
WORLD = 4
#: tests/test_sharded_gas.py's configuration and bounds
KW = dict(num_parts=8, batch_size=2, seed=0, epochs=2)
ATOL, RTOL = 2e-3, 1e-3


class Local(Trainer):
    """The unsharded trainer on the mesh's formats: hybrid, no global
    columns."""

    global_refresh = False


#: the other models under the mesh, and whether each trains Reverb
OTHERS = {"GAT": False, "GCN2": True, "GraphSAGE": True, "APPNP": False, "PNA_JK": False}


def _other_arch(name, data, in_c, out_c):
    base = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                hidden_channels=8, num_layers=2, dropout=0.0)
    if name == "GAT":
        return dict(base, hidden_heads=2, out_heads=1)
    if name == "PNA_JK":
        from incagg_gnn_tpu_torch.models.pna import compute_avg_deg

        lin, log = compute_avg_deg(data.adj_t.degrees())
        return dict(base, drop_input=False, aggregators=("mean", "max"),
                    scalers=("identity", "amplification"), avg_deg_lin=lin,
                    avg_deg_log=log)
    return base if name == "APPNP" else dict(base, drop_input=False)


def _gcn_arch(data, in_c, out_c):
    return dict(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=24,
                out_channels=out_c, num_layers=2, dropout=0.0, drop_input=False)


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _jax_run(data, arch, vr):
    """JAX ``Trainer(mesh=make_mesh(4))``: its initial parameters, fill
    logits, one epoch's loss, parameters and evaluation."""
    jt = JTrainer(JGCN(JGCNConfig(**arch)), data,
                  JTrainerConfig(**KW, vr_update=vr), mesh=make_mesh(WORLD))
    params = jax.tree.map(np.asarray, jt.params)
    state = jax.tree.map(np.asarray, jt.state)
    logits = np.asarray(jt.fill_history())
    loss = jt.train_epoch()["loss"]
    after = jax.tree.map(np.asarray, jt.params)
    return {"init": (params, state), "logits": logits, "loss": loss,
            "params": after, "eval": jt.evaluate()}


def _named(arch, tree, state):
    from torch_sharded_ranks import ModelOf

    m = ModelOf("GCN", arch, tree, state)()
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


@pytest.fixture(scope="module")
def runs(sbm_small, tmp_path_factory):
    """The JAX mesh runs, the port's unsharded runs and the mesh ranks'
    results, once."""
    from torch_sharded_ranks import ModelOf, SeededModel, mesh_parity, mesh_run

    data, in_c, out_c = sbm_small
    pdata = _port_data(data)
    arch = _gcn_arch(data, in_c, out_c)
    jax_res = {vr: _jax_run(data, arch, vr) for vr in (False, True)}
    makes = {vr: ModelOf("GCN", arch, *jax_res[vr]["init"]) for vr in (False, True)}
    cfgs = {vr: TrainerConfig(**KW, vr_update=vr) for vr in (False, True)}
    work = tmp_path_factory.mktemp("mesh")
    others = {"vr": (makes[True], pdata, cfgs[True]),
              **{name: (SeededModel(name, _other_arch(name, data, in_c, out_c)), pdata,
                        cfgs[vr]) for name, vr in OTHERS.items()}}
    ranks = run_mesh_trainer(mesh_parity, makes[False], pdata, cfgs[False], WORLD,
                             device="cpu", args=(others, str(work / "ckpt")),
                             workdir=str(work / "run"), threads=1)
    single = {}
    for tag, (make, _, cfg) in {"gas": (makes[False], pdata, cfgs[False]), **others}.items():
        cfg = dataclasses.replace(cfg, adj_format="hybrid", fused_epoch="off")
        single[tag] = mesh_run(Local(make(), pdata, cfg, "cpu"))
    return {"jax": jax_res, "ranks": ranks, "single": single, "ckpt": str(work / "ckpt"),
            "data": pdata, "makes": makes, "cfg": cfgs[False], "arch": arch}


def _same(got: dict, want: dict, tag: str) -> None:
    assert np.array_equal(got["logits"], want["logits"]), tag
    assert got["loss"] == want["loss"], (tag, got["loss"], want["loss"])
    for k, v in want["params"].items():
        assert np.array_equal(got["params"][k], v), (tag, k)
    assert got["eval"] == want["eval"], tag


@pytest.mark.parametrize("tag", ["gas", "vr"])
def test_mesh_matches_unsharded_and_jax(runs, tag):
    """Bit for bit the unsharded port ``Trainer``; within
    ``tests/test_sharded_gas.py``'s bounds of JAX's mesh ``Trainer``; the
    epoch loops and the refresh runs eagerly on the CPU, each saying why;
    every rank holds ``rows_pad / 4`` rows of each cache and table."""
    single, jres = runs["single"][tag], runs["jax"][tag == "vr"]
    n = runs["data"].num_nodes
    slab = rows_pad(n + 1, WORLD) // WORLD
    for r in runs["ranks"]:
        got = r[tag]
        _same(got, single, f"{tag} rank {r['rank']}")
        assert got["formats"] == ("hybrid", "hybrid-fwd", False)
        assert all(rows[0] == slab for rows in got["rows"]), got["rows"]
        assert all(rows[0] == n + 1 for rows in single["rows"])
        assert not got["epoch"]["fused"] and "CUDA graphs" in got["epoch"]["reason"]
        assert got["fill_plan"]["mechanism"] == "eager"
        assert "CUDA graphs" in got["fill_plan"]["reason"]
    got = runs["ranks"][0][tag]
    np.testing.assert_allclose(got["logits"], jres["logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["loss"], jres["loss"], atol=ATOL, rtol=RTOL)
    want = _named(runs["arch"], jres["params"], jres["init"][1])
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, atol=ATOL, rtol=RTOL, err_msg=k)
    assert abs(got["eval"]["val_acc"] - jres["eval"]["val_acc"]) < 0.05


def test_mesh_models_match_unsharded(runs):
    """The other models under the mesh, each bit for bit its unsharded run
    on the same formats: GAT GAS on the hybrid pair with its transpose slot
    permutation, GCNII Reverb (``x0`` pulled from ``M_in[0]``), GraphSAGE
    Reverb (the binary mean), APPNP GAS (caches in output space) and
    PNA_JK GAS (its own refresh batch, max aggregation)."""
    for name in OTHERS:
        for r in runs["ranks"]:
            _same(r[name], runs["single"][name], f"{name} rank {r['rank']}")
            assert r[name]["formats"] == ("hybrid", "hybrid-fwd", False), name


def test_mesh_checkpoint_restores_unsharded(runs):
    """The checkpoint the mesh wrote (rank 0, the slabs gathered) is the
    unsharded trainer's file: an unsharded trainer restores it into the
    mesh run's state, and its next epoch equals one from that state."""
    state = runs["ranks"][0]["gas"]["ckpt_state"]
    for r in runs["ranks"][1:]:
        for k, v in r["gas"]["ckpt_state"].items():
            assert np.array_equal(v, state[k]), k
    data, cfg = runs["data"], dataclasses.replace(runs["cfg"], adj_format="hybrid",
                                                  fused_epoch="off")
    tr = Local(runs["makes"][False](), data, cfg, "cpu")
    assert CheckpointManager(runs["ckpt"]).maybe_restore(tr)
    assert tr.epoch == 1
    got = tr.checkpoint_state()
    assert set(got) == set(state)
    for k, v in got.items():
        v = v.cpu().float().numpy() if v.is_floating_point() else v.cpu().numpy()
        assert np.array_equal(v, state[k]), k
    for k, v in tr.model.named_parameters():
        assert np.array_equal(v.detach().numpy(), runs["ranks"][0]["gas"]["params"][k]), k
    assert np.isfinite(tr.train_epoch()["loss"])


def test_mesh_policy(sbm_tiny, tmp_path):
    """Under a mesh: no dense tier and no global columns for the blockable
    models, ``adj_format=block`` refused with JAX's message; on a 2 x 2
    mesh the trainer builds with ``rows_pad / 2``-row slabs (rows sharded
    over the hosts only); the spill tier raises ``NotImplementedError``
    (JAX's spill trainer takes no mesh)."""
    from incagg_gnn_tpu_torch.history import local_rows
    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.train.spill_trainer import SpillVRTrainer

    data, in_c, out_c = sbm_tiny
    model = GCN(GCNConfig(**_gcn_arch(data, in_c, out_c)))
    cfg = TrainerConfig(**KW)
    assert choose_formats(model, cfg) == ("block", "block-fwd")
    assert choose_formats(model, cfg, sharded=True) == ("hybrid", "hybrid-fwd")
    with pytest.raises(ValueError, match="must not run under a GSPMD mesh"):
        choose_formats(model, dataclasses.replace(cfg, adj_format="block"), sharded=True)
    cpu = torch.device("cpu")
    mesh2d = M.Mesh(0, 4, cpu, "gloo", n_hosts=2)
    assert (mesh2d.chips, mesh2d.host, mesh2d.chip) == (2, 0, 0)
    # building runs one collective (the parameters' broadcast from rank 0):
    # a one-process group stands in for the other three ranks
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                                         world_size=1, rank=0)
    try:
        tr = Trainer(model, _port_data(data), cfg, "cpu", mesh=mesh2d)
    finally:
        M.shutdown()
    pad = rows_pad(data.num_nodes + 1, 4)
    for t in (*tr.hist.emb, *tr.hist.emb_ag, *tr.tables, tr.out_table):
        assert local_rows(t).shape[0] == pad // 2 and t.shape[0] == pad
    with pytest.raises(NotImplementedError, match="spill tier"):
        SpillVRTrainer(model, _port_data(data), dataclasses.replace(cfg, vr_update=True),
                       "cpu", mesh=M.Mesh(0, 4, cpu, "gloo"))
    assert M.capture_reason(M.Mesh(0, 4, cpu, "gloo")).startswith("CUDA graphs")
    assert M.capture_reason(M.Mesh(0, 4, torch.device("cuda", 0), "gloo")).startswith(
        "gloo runs its collectives on the host")
    assert M.capture_reason(M.Mesh(0, 1, torch.device("cuda", 0), "nccl")) == ""
