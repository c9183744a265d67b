"""The port's training slice against the JAX package's on sbm_small: the
``fill_history`` logits (atol 1e-4) and the first step's loss and
gradients (atol 1e-5), GCN in GAS and VR on the block and hybrid formats,
GraphSAGE on the block (VR) and COO (GAS, in-batch edges only) formats,
also after a failed load of the JAX package's native library; the port's
Adam against optax; and the port importing no JAX."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from incagg_gnn_tpu.models.gcn import GCN as JGCN
from incagg_gnn_tpu.models.gcn import GCNConfig as JCfg
from incagg_gnn_tpu.models.graphsage import GraphSAGE as JSAGE
from incagg_gnn_tpu.models.graphsage import SAGEConfig as JSAGECfg
from incagg_gnn_tpu.train.optim import make_optimizer
from incagg_gnn_tpu.train.steps import masked_loss as j_masked_loss
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.__main__ import resolve_device
from incagg_gnn_tpu_torch.convert import load_gcn_params, load_sage_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE, SAGEConfig
from incagg_gnn_tpu_torch.train.optim import Optimizer
from incagg_gnn_tpu_torch.train.steps import gas_loss, vr_loss
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(num_layers=2, hidden_channels=32, dropout=0.0, drop_input=False,
            batch_norm=True, residual=False)


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _jax_grads(jt, batch, vr, aggregate_combined=True):
    """Loss and parameter gradients of the JAX trainer's first step."""
    model, tb = jt.model, jt.tables
    x = jnp.take(tb.x, batch.n_id, axis=0).astype(jnp.float32)
    y = jnp.take(tb.y, batch.push_idx, axis=0)
    mask = jnp.take(tb.train_mask, batch.push_idx, axis=0)
    mask = mask & (jnp.arange(batch.push_idx.shape[0]) < batch.batch_size)

    def loss_fn(p):
        if vr:
            out = model.forward_vr(p, jt.state, x, batch, jt.hist, None, True)[0]
        else:
            out = model.forward_gas(p, jt.state, x, batch, jt.hist.emb, None, True,
                                    aggregate_combined)[0]
        return j_masked_loss(out, y, mask, False)[0]

    return jax.value_and_grad(loss_fn)(jt.params)


def _leaf(tree, name):
    """The JAX pytree leaf of a port parameter name (``convs.0.lin_l.w``)."""
    for key in name.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


#: (JAX model, its config, port model, its config, parameter loader)
MODELS = {
    "GCN": (JGCN, JCfg, GCN, GCNConfig, load_gcn_params),
    "GraphSAGE": (JSAGE, JSAGECfg, GraphSAGE, SAGEConfig, load_sage_params),
}


def _compare_slice(sbm, model, fmt, vr, aggregate_combined=True):
    """The port's trainer against the JAX package's on ``sbm``: the
    ``fill_history`` logits (atol 1e-4), then the first training batch's
    loss and every parameter gradient (atol 1e-5) from the filled caches."""
    data, in_c, out_c = sbm
    jcls, jcfg, tcls, tcfg, load = MODELS[model]
    kw = dict(num_parts=8, batch_size=2, adj_format=fmt, vr_update=vr, seed=0,
              epochs=1, aggregate_combined=aggregate_combined)
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **ARCH)
    jt = JTrainer(jcls(jcfg(**cfg)), data, JTrainerConfig(**kw))
    pt = Trainer(tcls(tcfg(**cfg)), _port_data(data), TrainerConfig(**kw), "cpu")
    load(pt.model, jax.tree.map(np.asarray, jt.params),
         jax.tree.map(np.asarray, jt.state))

    want = jt.fill_history()
    got = pt.fill_history()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if fmt == "block":
        assert pt.eval_loader.dense_tiles() > 0

    jb = next(iter(jt.train_loader)).device
    tb = next(iter(pt.train_loader)).device
    assert type(tb.adj).__name__ == type(jb.adj).__name__
    assert np.array_equal(np.asarray(jb.n_id), tb.n_id.numpy())
    jloss, jgrads = _jax_grads(jt, jb, vr, aggregate_combined)
    if vr:
        loss, _, _ = vr_loss(pt.model, tb, pt.tables, pt.hist, None)
    else:
        loss, _, _ = gas_loss(pt.model, tb, pt.tables, pt.hist.emb, None,
                              aggregate_combined=aggregate_combined)
    pt.opt.zero_grad()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=0)
    for name, p in pt.model.named_parameters():
        want = _leaf(jgrads, name)
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("model,fmt,vr,combined", [
    pytest.param("GCN", "block", False, True, id="block-gas"),
    pytest.param("GCN", "block", True, True, id="block-vr"),
    pytest.param("GCN", "hybrid", False, True, id="hybrid-gas"),
    pytest.param("GCN", "hybrid", True, True, id="hybrid-vr"),
    pytest.param("GraphSAGE", "block", True, True, id="sage-block-vr"),
    pytest.param("GraphSAGE", "coo", False, False, id="sage-coo-gas-ib-only"),
])
def test_slice_matches_jax(sbm_small, model, fmt, vr, combined):
    _compare_slice(sbm_small, model, fmt, vr, combined)


def test_slice_matches_jax_after_a_failed_native_load(sbm_small, monkeypatch):
    """The JAX package's native library failed to load in this process
    (simulated: ``_LIB`` None, ``_TRIED`` set), so its partitioner and
    builders would take their numpy fallbacks; the helper restores the
    native reference and the comparison holds."""
    from incagg_gnn_tpu.utils import native as jax_native
    from test_torch_native import use_native_jax_reference

    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    use_native_jax_reference(monkeypatch)
    assert jax_native.get_native_lib() is not None
    _compare_slice(sbm_small, "GCN", "hybrid", False)


def test_adam_matches_optax():
    """Clip, then reg/nonreg L2, then Adam: three steps on given gradients;
    parameters agree to 1e-6."""
    cfg = dict(num_nodes=10, in_channels=12, out_channels=5, **ARCH)
    jmodel = JGCN(JCfg(**cfg))
    params, state = jmodel.init(jax.random.PRNGKey(1))
    tmodel = GCN(GCNConfig(**cfg))
    load_gcn_params(tmodel, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, state))
    hp = dict(lr=0.01, reg_weight_decay=0.01, nonreg_weight_decay=0.001, grad_norm=0.5)
    tx = make_optimizer(jmodel.reg_mask(params), **hp)
    opt = Optimizer(tmodel, tmodel.reg_mask(), **hp)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        flat = {"convs": grads["convs"], "bns": grads["bns"]}
        for name, p in tmodel.named_parameters():
            group, i, leaf = name.split(".")
            p.grad = torch.from_numpy(np.asarray(flat[group][int(i)][leaf]))
        opt.step()
    for name, p in tmodel.named_parameters():
        group, i, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[group][int(i)][leaf]),
                                   atol=1e-6, rtol=0)


def test_cli_refuses_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of the port and running CPU training runs
    (GCN, GraphSAGE on COO with edge dropout, APPNP in VR mode) leaves jax
    and the JAX package out of ``sys.modules``; no source file of the port
    names them in an import."""
    import re

    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|incagg_gnn_tpu)\b(?!_torch)",
                         re.M)
    pkg = os.path.join(ROOT, "incagg_gnn_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                assert not pattern.search(src), os.path.join(dirpath, f)
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import incagg_gnn_tpu_torch
        for m in pkgutil.walk_packages(incagg_gnn_tpu_torch.__path__,
                                       "incagg_gnn_tpu_torch."):
            importlib.import_module(m.name)
        from incagg_gnn_tpu_torch.__main__ import main
        for model, extra in (("gcn", []), ("graphsage", ["edge_dropout=0.2"]),
                             ("appnp", ["vr_update=true"])):
            res = main(["--model", f"conf/model/{model}.yaml", "--dataset",
                        "sbm-small", "--device", "cpu", "epochs=1", "num_parts=4",
                        *extra])
            assert res["epochs"][0]["steps"] > 0
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "jaxlib", "optax", "incagg_gnn_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
