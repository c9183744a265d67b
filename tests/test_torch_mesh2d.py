"""The port's mesh ``Trainer`` on a ``(hosts x chips)`` mesh: four gloo
ranks on the CPU as a 2 x 2 mesh (``n_hosts=2``, host-major ranks),
spawned once for the module through
``parallel/launch.py::run_mesh_trainer``, at the configuration of the JAX
package's ``tests/test_sharded_gas.py`` (GCN on ``sbm_small``, 8 parts, 2
clusters a batch, hidden 24, 2 layers, dropout 0).  The rows are padded to
a multiple of the 4 ranks and sharded over the 2 hosts only, as JAX
``Trainer(mesh=make_mesh_2d(2, 2))`` places them with ``P("host")``:

- GAS and Reverb: the fill logits, one epoch's loss, the parameters and
  the evaluation's split counts equal the port's unsharded ``Trainer`` (on
  the same formats) bit for bit, and lie within that JAX test's bounds
  (``atol=2e-3, rtol=1e-3``) of JAX's 2 x 2 mesh ``Trainer`` from the same
  parameters; each rank holds ``rows_pad / 2`` rows of every cache and
  table, and the two chips of a host hold the same rows;
- the checkpoint written under the 2 x 2 mesh restores into the unsharded
  trainer and into a 2 x 2 mesh, and a refresh from it gives the same
  logits on all of them;
- ``scaling_bench --update-mesh2d`` rewrites only the 2-D row of a port
  artifact, and refuses a JAX one."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.parallel.mesh import make_mesh_2d
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch import scaling_bench
from incagg_gnn_tpu_torch.parallel.launch import run_mesh_trainer
from incagg_gnn_tpu_torch.parallel.rows import rows_pad
from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager
from incagg_gnn_tpu_torch.train.trainer import TrainerConfig
from test_torch_mesh_trainer import ATOL, KW, RTOL, Local, _gcn_arch, _named, _port_data, _same
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(1)
HOSTS, CHIPS = 2, 2
WORLD = HOSTS * CHIPS
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_run(data, arch, vr):
    """JAX ``Trainer(mesh=make_mesh_2d(2, 2))``: its initial parameters,
    fill logits, one epoch's loss, parameters and evaluation, and the
    placement of its first cache."""
    jt = JTrainer(JGCN(JGCNConfig(**arch)), data, JTrainerConfig(**KW, vr_update=vr),
                  mesh=make_mesh_2d(HOSTS, CHIPS))
    params = jax.tree.map(np.asarray, jt.params)
    state = jax.tree.map(np.asarray, jt.state)
    logits = np.asarray(jt.fill_history())
    loss = jt.train_epoch()["loss"]
    after = jax.tree.map(np.asarray, jt.params)
    cache = jt.hist.emb[0]
    return {"init": (params, state), "logits": logits, "loss": loss, "params": after,
            "eval": jt.evaluate(), "cache": (cache.shape, cache.sharding.spec)}


@pytest.fixture(scope="module")
def runs(sbm_small, tmp_path_factory):
    """The JAX 2 x 2 mesh runs, the port's unsharded runs and the 2 x 2
    ranks' results, once."""
    from torch_sharded_ranks import ModelOf, mesh2d_parity, mesh2d_run

    data, in_c, out_c = sbm_small
    pdata = _port_data(data)
    arch = _gcn_arch(data, in_c, out_c)
    jax_res = {vr: _jax_run(data, arch, vr) for vr in (False, True)}
    cases = {vr: (ModelOf("GCN", arch, *jax_res[vr]["init"]), pdata,
                  TrainerConfig(**KW, vr_update=vr)) for vr in (False, True)}
    work = tmp_path_factory.mktemp("mesh2d")
    ckpt = str(work / "ckpt")
    make, _, cfg = cases[False]
    ranks = run_mesh_trainer(mesh2d_parity, make, pdata, cfg, WORLD, device="cpu",
                             args=(cases[False], cases[True], ckpt),
                             workdir=str(work / "run"), threads=1, n_hosts=HOSTS)
    single = {}
    for vr, (mk, _, c) in cases.items():
        c = dataclasses.replace(c, adj_format="hybrid", fused_epoch="off")
        single["vr" if vr else "gas"] = mesh2d_run(Local(mk(), pdata, c, "cpu"))
    return {"jax": jax_res, "ranks": ranks, "single": single, "ckpt": ckpt,
            "data": pdata, "case": cases[False], "arch": arch}


@pytest.mark.parametrize("tag", ["gas", "vr"])
def test_mesh2d_matches_unsharded_and_jax(runs, tag):
    """Bit for bit the unsharded port ``Trainer``, split counts included;
    within ``tests/test_sharded_gas.py``'s bounds of JAX's 2 x 2 mesh
    ``Trainer``, whose caches are ``[rows_pad, D]`` under ``P("host")``;
    every rank holds ``rows_pad / 2`` rows (the trash row ``N`` in host
    1's slab) and a host's two chips hold the same rows."""
    single, jres = runs["single"][tag], runs["jax"][tag == "vr"]
    n = runs["data"].num_nodes
    pad = rows_pad(n + 1, WORLD)
    slab = pad // HOSTS
    assert n >= slab  # the trash row lies in host 1's slab
    assert jres["cache"][0][0] == pad and tuple(jres["cache"][1]) == ("host",)
    for r in runs["ranks"]:
        got = r[tag]
        assert (r["host"], r["chip"]) == divmod(r["rank"], CHIPS)
        _same(got, single, f"{tag} rank {r['rank']}")
        assert np.array_equal(got["counts"], single["counts"]), (got["counts"],
                                                                 single["counts"])
        assert got["formats"] == ("hybrid", "hybrid-fwd", False)
        assert all(rows[0] == slab for rows in got["rows"]), got["rows"]
        assert not got["epoch"]["fused"] and "CUDA graphs" in got["epoch"]["reason"]
        assert got["fill_plan"]["mechanism"] == "eager"
        # this host's rows of the unsharded trainer's tables
        lo = r["host"] * slab
        for mine, whole in zip(got["slabs"], single["slabs"]):
            want = np.zeros_like(mine)
            part = whole[lo:lo + slab]
            want[:len(part)] = part
            assert np.array_equal(mine, want), (tag, r["rank"])
    for a, b in ((0, 1), (2, 3)):
        for x, y in zip(runs["ranks"][a][tag]["slabs"], runs["ranks"][b][tag]["slabs"]):
            assert np.array_equal(x, y), (tag, a, b)
    got = runs["ranks"][0][tag]
    np.testing.assert_allclose(got["logits"], jres["logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["loss"], jres["loss"], atol=ATOL, rtol=RTOL)
    want = _named(runs["arch"], jres["params"], jres["init"][1])
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k], v, atol=ATOL, rtol=RTOL, err_msg=k)
    assert abs(got["eval"]["val_acc"] - jres["eval"]["val_acc"]) < 0.05


def test_mesh2d_checkpoint_restores_unsharded(runs):
    """The checkpoint the 2 x 2 mesh wrote (rank 0, each host's slab
    gathered once) is the unsharded trainer's file: the unsharded trainer
    and a 2 x 2 mesh restore it into the same state, and a refresh from it
    gives the same logits on both and on the mesh that wrote it."""
    state = runs["ranks"][0]["gas"]["ckpt_state"]
    make, data, cfg = runs["case"]
    tr = Local(make(), data, dataclasses.replace(cfg, adj_format="hybrid",
                                                 fused_epoch="off"), "cpu")
    assert CheckpointManager(runs["ckpt"]).maybe_restore(tr)
    assert tr.epoch == 1
    got = tr.checkpoint_state()
    assert set(got) == set(state)
    for k, v in got.items():
        v = v.cpu().float().numpy() if v.is_floating_point() else v.cpu().numpy()
        assert np.array_equal(v, state[k]), k
        assert v.shape[:1] == state[k].shape[:1]
    logits = tr._sweep()
    for r in runs["ranks"]:
        for k, v in state.items():
            assert np.array_equal(r["gas"]["ckpt_state"][k], v), (r["rank"], k)
            assert np.array_equal(r["restored"]["state"][k], v), (r["rank"], k)
        assert r["restored"]["epoch"] == 1
        assert np.array_equal(r["restored"]["logits"], logits), r["rank"]
        assert np.array_equal(r["gas"]["resumed_logits"], logits), r["rank"]


def _bench(artifact, mesh2d="2x2", *more):
    """``scaling_bench --update-mesh2d artifact`` on a graph whose 2-D leg
    takes seconds on CPU ranks."""
    return scaling_bench.main([
        "--device", "cpu", "--num-nodes", "1200", "--num-parts", "8", "--hidden", "8",
        "--layers", "2", "--mesh2d", mesh2d, "--min-reps", "2", "--max-reps", "2",
        "--max-start-load", "1e9", "--update-mesh2d", str(artifact), *more])


def test_update_mesh2d_rewrites_only_the_2d_row(tmp_path):
    """``--update-mesh2d``: a port artifact keeps everything but its
    ``mesh2d`` row, its note, its ``mesh2d:`` issues and the ``valid`` they
    decide; the new row is a 2 x 2 leg against the artifact's one-rank
    baseline.  A JAX ``SCALING_r*.json``, a port artifact of another graph
    and ``--mesh2d none`` are refused, the file untouched."""
    one = {"devices": 1, "train_s_full": 1.0, "train_s_loopback": 0.9,
           "refresh_s_full": 0.5, "refresh_s_loopback": 0.4}
    art = {"harness": scaling_bench.HARNESS, "platform": "CPU ranks over gloo; 4 host CPUs",
           "device": "cpu", "card": "CPU",
           "graph": {"num_nodes": 1200, "avg_degree": 14.0, "edges": 0, "num_parts": 8,
                     "mode": "gas", "model": "GCN 2x8", "seed": 0},
           "decomposition": [one], "suspect_legs": [],
           "consistency_issues": ["nd=4: kept as it was", "mesh2d: the old row's"],
           "mesh2d": {"devices": 4, "stale": True}, "valid": False,
           "halo_bytes": {"payload_rows_per_sweep_layer": 7}}
    path = tmp_path / "scaling_port.json"
    path.write_text(json.dumps(art))
    _bench(path, "2x2", "--workdir", str(tmp_path / "legs"))
    new = json.loads(path.read_text())
    changed = {"mesh2d", "mesh2d_note", "consistency_issues", "valid"}
    assert {k: v for k, v in new.items() if k not in changed} == {
        k: v for k, v in art.items() if k not in changed}
    row = new["mesh2d"]
    assert row["devices"] == WORLD and row["mesh"].startswith("2x2")
    assert row["train_s_full"] > 0 and row["train_s_loopback"] > 0
    loop = row["train_s_loopback"] + row["refresh_s_loopback"]
    t1 = one["train_s_loopback"] + one["refresh_s_loopback"]
    assert row["sharding_overhead_vs_1dev"] == round(loop / t1 - 1.0, 4)
    assert set(row["edge_locality_hierarchical"]) == {"intra_device", "intra_host",
                                                      "cross_host"}
    assert "--update-mesh2d" in new["mesh2d_note"]
    issues = new["consistency_issues"]
    assert issues[0] == "nd=4: kept as it was"
    assert all(i.startswith("mesh2d: ") for i in issues[1:])
    assert "mesh2d: the old row's" not in issues
    assert new["valid"] == (not issues and not new["suspect_legs"])
    # refusals, before any leg runs
    jax_copy = tmp_path / "SCALING_r05.json"
    shutil.copy(os.path.join(REPO, "SCALING_r05.json"), jax_copy)
    renamed = tmp_path / "scaling_port_r09.json"
    shutil.copy(jax_copy, renamed)
    for bad in (jax_copy, renamed):
        before = bad.read_text()
        with pytest.raises(SystemExit):
            _bench(bad)
        assert bad.read_text() == before
    other = tmp_path / "scaling_port_r10.json"
    other.write_text(json.dumps({**art, "graph": {**art["graph"], "num_nodes": 999}}))
    with pytest.raises(SystemExit, match="measured the graph"):
        _bench(other)
    with pytest.raises(SystemExit):
        _bench(path, "none")
    assert json.loads(path.read_text()) == new
