"""The port's sharded trainer (``parallel/spatial.py``), four gloo ranks on
the CPU spawned once for the module, against the JAX package's
``ShardedVRTrainer`` on ``make_mesh(4)`` of the conftest's virtual CPU
mesh, with the JAX trainer's parameters carried across by ``convert.py``
and dropout off: refresh logits within 1e-4 (GCN hybrid, GCNII block, GAT
Reverb on the hybrid pair with ``t2f`` and GAS on COO, PNA ``true_vr`` with
a max branch), the first step's gradients within 1e-5, the parameters after
one Reverb epoch and one GAS epoch within 1e-4; the spill tier
(``parallel/spill_sharded.py``) in GCN Reverb and GAS against the same JAX
runs and equal to the device-cache run of the same ranks at f32; the
``dense`` and ``ragged`` wires bit for bit; the ``loopback`` wire against
the JAX trainer's, with no all-to-all; the exchange's forward and backward
against autograd of a one-process emulation; the pipelined refresh equal
to the serial loop bit for bit, its collects issued a round ahead; a
resumed run equal to the uninterrupted one, with device caches and
spilled; the CLI's ``--runs`` loop equal to a run at each seed;
``scaling_bench``'s full and loopback legs; and the launcher's refusals,
memory gate and failure code."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GAT as JGAT
from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCN2 as JGCN2
from incagg_gnn_tpu.models import PNA as JPNA
from incagg_gnn_tpu.models import GATConfig as JGATConfig
from incagg_gnn_tpu.models import GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.models import PNAConfig as JPNAConfig
from incagg_gnn_tpu.models.pna import compute_avg_deg
from incagg_gnn_tpu.parallel.mesh import make_mesh
from incagg_gnn_tpu.parallel.spatial import ShardedVRTrainer as JSharded
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.gcn import GCNConfig
from incagg_gnn_tpu_torch.parallel import mesh as M
from incagg_gnn_tpu_torch.parallel.launch import RankFailed, memory_gate, spawn_ranks
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(1)
WORLD = 4
CASES = {
    "gcn-hybrid-vr": ("GCN", dict(adj_format="hybrid", vr_update=True)),
    "gcn-hybrid-gas": ("GCN", dict(adj_format="hybrid", vr_update=False)),
    "gcn2-block-vr": ("GCN2", dict(adj_format="block", vr_update=True)),
    # the settings of the JAX package's own sharded GAT and PNA tests
    # (tests/test_multichip.py): GAT Reverb on the hybrid pair with t2f, GAT
    # GAS on COO, PNA true_vr with a max branch
    "gat-hybrid-vr": ("GAT", dict(adj_format="auto", vr_update=True)),
    "gat-coo-gas": ("GAT", dict(adj_format="auto", vr_update=False)),
    "pna-true-vr-max": ("PNA", dict(adj_format="auto", vr_update=True)),
}
#: the cases also run through the spill tier, as ``f"{tag}-spill"``
SPILL = ("gcn-hybrid-vr", "gcn-hybrid-gas")
VR = ["gcn-hybrid-vr", "gcn2-block-vr", "gat-hybrid-vr", "pna-true-vr-max",
      "gcn-hybrid-vr-spill"]
ALL = [*CASES, *(f"{t}-spill" for t in SPILL)]


def _arch(data, in_c, out_c, name):
    base = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                num_layers=2, dropout=0.0)
    if name == "GAT":
        return dict(base, hidden_channels=8, hidden_heads=2, out_heads=1)
    if name == "PNA":
        lin, log = compute_avg_deg(data.adj_t.degrees())
        return dict(base, hidden_channels=16, drop_input=False, true_vr=True,
                    aggregators=("mean", "max"), scalers=("identity",),
                    avg_deg_lin=lin, avg_deg_log=log)
    return dict(base, hidden_channels=16 if name == "GCN" else 24, drop_input=False)


def _jax_model(name, arch):
    cls, cfg = {"GCN": (JGCN, JGCNConfig), "GCN2": (JGCN2, JGCN2Config),
                "GAT": (JGAT, JGATConfig), "PNA": (JPNA, JPNAConfig)}[name]
    return cls(cfg(**arch))


def _port_model(name, arch):
    from torch_sharded_ranks import _model

    return _model(name, arch)


def _jax_of(tag):
    """The JAX run a case is held against (a spill case: its device twin's)."""
    return tag[:-len("-spill")] if tag.endswith("-spill") else tag


def _named(name, arch, tree, state):
    """A JAX parameter tree (parameters or gradients) by the port's names."""
    m = _port_model(name, arch)
    load_params(m, jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, state))
    return {k: v.detach().numpy() for k, v in m.named_parameters()}


def _jax_first_grads(jt):
    """The JAX trainer's first Reverb step's gradients (round 0): each
    device's gradient of its masked loss on its slab, weighted by its
    train rows and normalized by their total (JAX ``_vr_step_core``)."""
    slab, model = jt.layout.slab, jt.model
    stack = jax.tree.map(np.asarray, jt._train_stacks[0])
    total, n_tot = None, 0.0
    for d in range(jt.n_dev):
        rows = slice(d * slab, (d + 1) * slab)
        b = jax.tree.map(lambda a: jnp.asarray(a[d]), stack)
        hist = type(jt.hist)(tuple(t[rows] for t in jt.hist.emb),
                             tuple(t[rows] for t in jt.hist.emb_ag))
        x = jnp.take(jt.x_tab[rows], b.n_id, axis=0)
        y = jnp.take(jt.y_tab[rows], b.push_idx, axis=0)
        mask = jnp.take(jt.tm_tab[rows], b.push_idx, axis=0) & (
            jnp.arange(b.push_idx.shape[0]) < b.batch_size)

        def loss_fn(p):
            out, _, _ = model.forward_vr(p, jt.state, x, b, hist, jax.random.PRNGKey(0),
                                         True, jt.cfg.drift_norm)
            return j_masked_loss(out, y, mask, jt.multilabel)

        (_, n), g = jax.value_and_grad(loss_fn, has_aux=True)(jt.params)
        g = jax.tree.map(lambda a: np.asarray(a, np.float64) * float(n), g)
        total = g if total is None else jax.tree.map(np.add, total, g)
        n_tot += float(n)
    return jax.tree.map(lambda a: (a / max(n_tot, 1.0)).astype(np.float32), total)


@pytest.fixture(scope="module")
def runs(sbm_small, tmp_path_factory):
    """The JAX trainers' results and the port ranks' results, once.

    The JAX trainers run their ``shard_map`` with ``check_vma=False``.
    Under the default, this JAX differentiates the replicated parameters
    with an implicit ``psum``, so the step's ``psum`` of the gradients
    weighted by each device's train rows applies ``Σ_d g_d``, not the
    global mean over train rows that its code spells out
    (``incagg_gnn_tpu/parallel/spatial.py:750-755``) and the port computes.
    Without the check the same code reduces as written."""
    import functools

    import incagg_gnn_tpu.parallel.spatial as J_spatial

    data, in_c, out_c = sbm_small
    jax_res, cases = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_spatial, "shard_map", functools.partial(jax.shard_map,
                                                             check_vma=False))
        _jax_runs(data, in_c, out_c, jax_res, cases)
    pdata = T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)
    work = tmp_path_factory.mktemp("sharded")
    ranks = spawn_ranks(_rank_fn(), WORLD, [torch.device("cpu")] * WORLD, "gloo",
                        args=(cases, pdata, str(work / "ckpt"), SPILL),
                        workdir=str(work / "run"), threads=1)
    return jax_res, ranks, data.num_nodes


def _jax_runs(data, in_c, out_c, jax_res, cases):
    for tag, (name, fmt) in CASES.items():
        arch = _arch(data, in_c, out_c, name)
        kw = dict(num_parts=8, batch_size=1, seed=0, lr=0.01, **fmt)
        jm = _jax_model(name, arch)
        jt = JSharded(jm, data, JTrainerConfig(**kw), mesh=make_mesh(WORLD))
        params = jax.tree.map(np.asarray, jt.params)
        state = jax.tree.map(np.asarray, jt.state)
        cases[tag] = (name, arch, kw, params, state)
        logits = jt.fill_history()
        grads = _jax_first_grads(jt) if fmt["vr_update"] else None
        loss = jt.train_epoch()["loss"]
        jax_res[tag] = {"logits": logits, "loss": loss,
                        "grads": None if grads is None else _named(name, arch, grads,
                                                                   jt.state),
                        "params": _named(name, arch, jt.params, jt.state)}
    # the GAS case's refresh over the loopback wire (its parameters: the
    # GAS case's, drawn from the same seed)
    name, arch, kw, params, _ = cases["gcn-hybrid-gas"]
    jt = JSharded(_jax_model(name, arch), data, JTrainerConfig(**kw, halo_wire="loopback"),
                  mesh=make_mesh(WORLD))
    same = jax.tree.map(lambda a, b: bool(np.array_equal(np.asarray(a), b)), jt.params,
                        params)
    jax_res["loopback"] = {"logits": jt.fill_history(),
                           "same_params": all(jax.tree.leaves(same))}


def _rank_fn():
    from torch_sharded_ranks import parity

    return parity


@pytest.mark.parametrize("tag", ALL)
def test_refresh_matches_jax(runs, tag):
    jax_res, ranks, _ = runs
    want = jax_res[_jax_of(tag)]["logits"]
    for r in ranks:
        np.testing.assert_allclose(r[tag]["logits"], want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tag", VR)
def test_first_step_grads_match_jax(runs, tag):
    jax_res, ranks, _ = runs
    want = jax_res[_jax_of(tag)]["grads"]
    for r in ranks:
        assert set(r[tag]["grads"]) == set(want)
        for k, g in r[tag]["grads"].items():
            np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("tag", ALL)
def test_epoch_params_match_jax(runs, tag):
    """One Reverb epoch (rounds in stack order, JAX's scan) or one GAS
    epoch (rounds permuted by ``(seed, 0)``): parameters within 1e-4 of
    JAX's, equal on every rank; the epoch's loss within 1e-5."""
    jax_res, ranks, _ = runs
    want = jax_res[_jax_of(tag)]["params"]
    for r in ranks:
        for k, p in r[tag]["params"].items():
            np.testing.assert_allclose(p, want[k], atol=1e-4, rtol=0, err_msg=k)
            assert np.array_equal(p, ranks[0][tag]["params"][k]), k
        assert abs(r[tag]["loss"] - jax_res[_jax_of(tag)]["loss"]) <= 1e-5


@pytest.mark.parametrize("tag", SPILL)
def test_spill_tier_equals_the_device_caches(runs, tag):
    """The spill tier and the device-cache trainer of the same ranks, at
    f32 caches: the refresh logits, the first step's gradients, the loss
    and parameters after one epoch and both caches after it (a GAS epoch
    writes its pushes back to the host tables) bit for bit."""
    _, ranks, _ = runs
    for r in ranks:
        dev, spill = r[tag], r[f"{tag}-spill"]
        assert np.array_equal(dev["logits"], spill["logits"])
        assert dev["loss"] == spill["loss"]
        for k in dev["params"]:
            assert np.array_equal(dev["params"][k], spill["params"][k]), k
        for k in dev["grads"]:
            assert np.array_equal(dev["grads"][k], spill["grads"][k]), k
        assert len(dev["caches"]) == len(spill["caches"]) == 4
        for a, b in zip(dev["caches"], spill["caches"]):
            assert np.array_equal(a, b)
        # the refresh wrote every table back; GAS also staged its pulls
        assert spill["bytes"]["d2h"] > 0 and spill["bytes"]["h2d"] > 0


def test_dense_and_ragged_wires_agree_bit_for_bit(runs):
    _, ranks, _ = runs
    for r in ranks:
        dense, ragged = r["wires"]["dense"], r["wires"]["ragged"]
        assert (dense["wire"], ragged["wire"]) == ("dense", "ragged")
        assert np.array_equal(dense["logits"], ragged["logits"])
        for a, b in zip(dense["caches"], ragged["caches"]):
            assert np.array_equal(a, b)
        for k in dense["params"]:
            assert np.array_equal(dense["params"][k], ragged["params"][k]), k
        assert np.array_equal(dense["out"], ragged["out"])
        assert dense["calls"]["all_to_all"] > 0


@pytest.mark.parametrize("wire", ["dense", "ragged", "loopback"])
def test_exchange_backward_matches_autograd_emulation(runs, wire):
    """One process emulates the round-0 exchange as a gather of the global
    rows ``n_id`` from the stacked slabs; autograd of that gather gives
    each slab's cotangent, which the ranks' transposed exchange must
    equal (the forward: bit for bit).  Under ``loopback`` each rank's
    exchange is its own: the rows of other ranks are read from the rank's
    staging ``src[send_idx]``, which the emulation gathers too."""
    _, ranks, _ = runs
    res = [r["wires"][wire] for r in ranks]
    if wire == "loopback":
        for r in res:
            p = {k: torch.from_numpy(v) for k, v in r["plan"].items()}
            src = torch.tensor(r["src"], requires_grad=True)
            out = torch.where(p["is_local"], src.index_select(0, p["local_pos"]),
                              src.index_select(0, p["send_idx"]).index_select(
                                  0, p["remote_pos"]))
            assert np.array_equal(out.detach().numpy(), r["out"])
            (d_src,) = torch.autograd.grad(out, src, torch.from_numpy(r["g"]))
            np.testing.assert_allclose(r["d_src"], d_src.numpy(), atol=1e-5, rtol=0)
        return
    table = torch.tensor(np.concatenate([r["src"] for r in res]), requires_grad=True)
    outs = [table.index_select(0, torch.from_numpy(r["n_id"])) for r in res]
    for o, r in zip(outs, res):
        assert np.array_equal(o.detach().numpy(), r["out"])
    loss = sum((o * torch.from_numpy(r["g"])).sum() for o, r in zip(outs, res))
    (d_table,) = torch.autograd.grad(loss, table)
    slab = res[0]["src"].shape[0]
    for i, r in enumerate(res):
        np.testing.assert_allclose(r["d_src"], d_table[i * slab:(i + 1) * slab].numpy(),
                                   atol=1e-5, rtol=0)


def test_loopback_wire_matches_jax_and_moves_nothing(runs):
    """GCN hybrid GAS over ``halo_wire=loopback``: the refresh logits
    within 1e-4 of the JAX trainer's loopback refresh (from the same
    parameters), and no all-to-all in its set-up, refresh, epoch and
    exchange."""
    jax_res, ranks, _ = runs
    assert jax_res["loopback"]["same_params"]
    want = jax_res["loopback"]["logits"]
    for r in ranks:
        lb = r["wires"]["loopback"]
        assert lb["wire"] == "loopback"
        np.testing.assert_allclose(lb["logits"], want, atol=1e-4, rtol=0)
        assert lb["moved"]["all_to_all"] == 0
        assert r["wires"]["dense"]["moved"]["all_to_all"] > 0
    # across more than one rank the loopback refresh is not the real one
    assert not np.allclose(ranks[0]["wires"]["loopback"]["logits"],
                           ranks[0]["wires"]["dense"]["logits"], atol=1e-4)


@pytest.mark.parametrize("tag", [*ALL, "bf16-device", "bf16-spill", "gcn-hybrid-gas-16"])
def test_pipelined_refresh_equals_the_serial_loop(runs, tag):
    """The refresh (round ``r + 1``'s collect in flight while round ``r``
    computes) against the serial loop rebuilt from ``collect`` /
    ``assemble`` / ``_refresh_batch`` on the same state: logits and caches
    bit for bit, and ``layers x rounds`` all-to-alls a refresh."""
    _, ranks, _ = runs
    for r in ranks:
        got = r["bf16"][tag[len("bf16-"):]] if tag.startswith("bf16") else r[tag]
        assert np.array_equal(got["logits"], got["serial"]["logits"])
        assert len(got["refresh_caches"]) == len(got["serial"]["caches"]) == 4
        for a, b in zip(got["refresh_caches"], got["serial"]["caches"]):
            assert np.array_equal(a, b)
        assert got["refresh_a2a"] == got["layers_x_rounds"] > 0


def test_refresh_collects_a_round_ahead(runs):
    """In each layer pass the refresh collects round 0, then for each round
    ``r`` issues round ``r + 1``'s collect before it computes round ``r``;
    the last round issues none (GCN hybrid GAS at 16 parts: four rounds)."""
    _, ranks, _ = runs
    for r in ranks:
        events = r["order"]
        layers = sorted({e[1] for e in events if e[0] == "compute"})
        rounds = len(events) // len(layers) // 2
        assert rounds == 4
        want = []
        for layer in layers:
            want.append(("collect", 0))
            for i in range(rounds):
                if i + 1 < rounds:
                    want.append(("collect", i + 1))
                want.append(("compute", layer))
        assert events == want


def test_runs_loop_equals_a_run_at_each_seed(runs):
    """The CLI's rank function with ``runs=2`` (seeds ``base``, ``base +
    1``) equals, run for run, a separate run at that seed: best val/test
    and the epoch's loss; the summary is their mean."""
    _, ranks, _ = runs
    for r in ranks:
        res = r["runs"]
        assert res["looped"] == res["single"]
        assert res["mean"] == (np.mean([x["best_val"] for x in res["single"]]),
                               np.mean([x["best_test"] for x in res["single"]]))
    # the two seeds train differently
    assert ranks[0]["runs"]["single"][0] != ranks[0]["runs"]["single"][1]


def test_scaling_bench_legs_make_a_row(runs):
    """``scaling_bench``'s leg on this graph: a full (dense) and a loopback
    run of one trainer on every rank, timed, the loopback's without an
    all-to-all, the microbench at the eval halo's shape, and a
    decomposition row of the harness's keys."""
    from incagg_gnn_tpu_torch.scaling_bench import make_row, row_issues

    _, ranks, _ = runs
    legs = [r["legs"] for r in ranks]
    for leg in legs:
        assert leg["dense"]["wire"] == "dense" and leg["loopback"]["wire"] == "loopback"
        assert leg["loopback"]["all_to_all"] == 0 < leg["dense"]["all_to_all"]
        for wire in ("dense", "loopback"):
            assert len(leg[wire]["train_all"]) == 2 and leg[wire]["train_s"] > 0
            assert len(leg[wire]["refresh_all"]) == 2 and leg[wire]["refresh_s"] > 0
        assert leg["a2a"]["halo_width"] == leg["dense"]["halo_width"] > 0
    # every rank timed the slowest rank's repetitions
    assert all(leg["dense"]["train_all"] == legs[0]["dense"]["train_all"] for leg in legs)
    row = make_row(WORLD, {"full": legs[0]["dense"], "loop": legs[0]["loopback"],
                           "setup_s": legs[0]["setup_s"], "backend": "gloo",
                           "loadavg_at_leg": [0.0, 0.0, 0.0]})
    assert {"devices", "train_s_full", "train_s_loopback", "refresh_s_full",
            "refresh_s_loopback", "train_s_all_reps", "edges_per_s_full",
            "loadavg_at_leg"} <= set(row)
    assert row["all_to_all_per_refresh_and_epoch_loopback"] == 0
    assert isinstance(row_issues(row), list)


def test_spill_tier_at_bf16_equals_the_device_caches(runs):
    """Reverb with bfloat16 caches: the spill tier's host tables hold the
    cache dtype, and its staged rows widen to the same f32 values as the
    device tables' pulls, so the two tiers agree bit for bit.  (GAS at a
    narrow dtype differs, as in the JAX package: the spill tier splices
    this round's fresh pushes in f32, the device tier reads them back
    rounded.)"""
    _, ranks, _ = runs
    for r in ranks:
        dev, spill = r["bf16"]["device"], r["bf16"]["spill"]
        assert np.array_equal(dev["logits"], spill["logits"])
        assert dev["loss"] == spill["loss"]
        for k in dev["params"]:
            assert np.array_equal(dev["params"][k], spill["params"][k]), k
        for a, b in zip(dev["caches"], spill["caches"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("key", ["resume", "resume-spill"])
def test_resumed_run_equals_the_uninterrupted_one(runs, key):
    _, ranks, _ = runs
    for r in ranks:
        res = r[key]
        assert res["restored"] and res["start"] == 1
        assert res["loss"][0] == res["loss"][1]
        assert res["eval"][0] == res["eval"][1]
        for k in res["params"][0]:
            assert np.array_equal(res["params"][0][k], res["params"][1][k]), k
        for a, b in zip(*res["caches"]):
            assert np.array_equal(a, b)


def test_failing_rank_fails_the_run(tmp_path):
    from torch_sharded_ranks import failing

    with pytest.raises(RankFailed) as e:
        spawn_ranks(failing, 2, [torch.device("cpu")] * 2, "gloo", workdir=str(tmp_path),
                    threads=1)
    assert e.value.rank == 1 and e.value.code == 1


def test_refusals(sbm_small, monkeypatch):
    """NCCL with two ranks on one device and PNA_JK are refused, each
    naming what to use or why; GAT, PNA and the ``loopback`` wire (by name
    only) are admitted; a slab over the memory budget selects the spill
    tier."""
    from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
    from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
    from incagg_gnn_tpu_torch.models.pna_jk import PNA_JK
    from incagg_gnn_tpu_torch.parallel.launch import spill_line
    from incagg_gnn_tpu_torch.parallel.spatial import check_sharded, resolve_wire
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        M.place_ranks("cpu", 2, "nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        M.place_ranks("cuda:0", 2, "nccl")
    assert M.place_ranks("cuda:0", 2, "gloo") == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--device cuda:0 --dist-backend gloo"):
        M.place_ranks("cuda", 2, "nccl")
    data, in_c, out_c = sbm_small
    base = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                hidden_channels=16, num_layers=2)
    for m in (GAT(GATConfig(**base)),
              PNA(PNAConfig(**base, avg_deg_lin=1.0, avg_deg_log=1.0))):
        check_sharded(m, TrainerConfig())
        check_sharded(m, TrainerConfig(vr_update=True))
    # the JAX package's sharded refresh writes PNA_JK's last hidden output
    # into the logits slab, (56, 16) into (56, 4) on sbm-tiny (ROADMAP §3)
    with pytest.raises(NotImplementedError, match="JK head never runs"):
        check_sharded(PNA_JK(PNAConfig(**base, avg_deg_lin=1.0, avg_deg_log=1.0)),
                      TrainerConfig())
    # loopback is admitted by name, never chosen by auto; unknown wires refused
    check_sharded(_port_model("GCN", _arch(data, in_c, out_c, "GCN")),
                  TrainerConfig(halo_wire="loopback"))
    assert {resolve_wire("auto", b) for b in ("gloo", "nccl")} == {"dense", "ragged"}
    assert resolve_wire("loopback", "nccl") == "loopback"
    with pytest.raises(ValueError, match="unknown halo_wire"):
        resolve_wire("local", "gloo")
    cfg = GCNConfig(**base)
    monkeypatch.setenv("INCAGG_HBM_BUDGET_MB", "1")
    gate = memory_gate(cfg, 64, "float32", data.num_nodes, [torch.device("cpu")] * 4)
    assert gate["cpu"]["spill"] and gate["cpu"]["cache_bytes"] > 1 << 20
    assert spill_line(gate).startswith("sharded spill tier: cache slab")
    monkeypatch.setenv("INCAGG_HBM_BUDGET_MB", "1000")
    gate = memory_gate(cfg, 64, "float32", data.num_nodes, [torch.device("cpu")] * 4)
    assert gate["cpu"]["ranks"] == 4 and not gate["cpu"]["spill"]
