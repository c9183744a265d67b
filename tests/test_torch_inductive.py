"""The inductive (PPI) protocol in the port against the JAX package:
``Trainer.full_forward`` on the separate val and test graphs of ``sbm-ppi``
matches the JAX trainer's within 1e-4 with the same converted GraphSAGE
weights, on the hybrid and the dense-tile formats (the JAX function
aggregates by COO, the port by the trainer's eval format); on the training
graph it equals ``fill_history`` permuted and leaves the trainer's caches,
logits table and refresh plan as they were; the CLI reports val/test from
the separate graphs, on ``sbm-ppi`` and on a ``ppi`` archive written by the
port's converter from PyG PPI raw files (``chip_smoke.py``'s writer);
``--spill`` with an inductive dataset is refused."""

import os

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.graph.datasets import make_sbm_inductive
from incagg_gnn_tpu.models.graphsage import GraphSAGE as JSAGE
from incagg_gnn_tpu.models.graphsage import SAGEConfig as JCfg
from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch import convert_dataset as T_conv
from incagg_gnn_tpu_torch.__main__ import main
from incagg_gnn_tpu_torch.convert import load_sage_params
from incagg_gnn_tpu_torch.graph import datasets as T_ds
from incagg_gnn_tpu_torch.models.graphsage import GraphSAGE, SAGEConfig
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from chip_smoke import write_ppi_raw
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)
from test_torch_trainer import _port_data

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAGE_YAML = os.path.join(ROOT, "conf", "model", "graphsage.yaml")
# the ppi block's architecture (3 layers, residual, no BatchNorm) narrowed
ARCH = dict(num_layers=3, hidden_channels=32, dropout=0.0, drop_input=False,
            batch_norm=False, residual=True)
SPLITS = dict(num_nodes=400, num_classes=6, num_features=12, seed=0)


@pytest.fixture(scope="module")
def ppi():
    graphs = {s: make_sbm_inductive(split=s, **SPLITS)[0] for s in ("train", "val", "test")}
    data = graphs["train"]
    cfg = dict(num_nodes=data.num_nodes, in_channels=data.num_features,
               out_channels=data.num_classes, **ARCH)
    kw = dict(num_parts=4, batch_size=2, seed=0, epochs=1)
    jt = JTrainer(JSAGE(JCfg(**cfg)), data, JTrainerConfig(**kw))
    params = jax.tree.map(np.asarray, jt.params)
    state = jax.tree.map(np.asarray, jt.state)

    def port_trainer(adj_format):
        pt = Trainer(GraphSAGE(SAGEConfig(**cfg)), _port_data(data),
                     TrainerConfig(adj_format=adj_format, **kw), "cpu")
        load_sage_params(pt.model, params, state)
        return pt

    want = {s: jt.full_forward(graphs[s]) for s in ("val", "test")}
    return dict(graphs=graphs, want=want, port_trainer=port_trainer)


@pytest.mark.parametrize("fmt,eval_fmt", [("hybrid", "hybrid-fwd"), ("block", "block-fwd")])
def test_full_forward_matches_jax(ppi, fmt, eval_fmt):
    pt = ppi["port_trainer"](fmt)
    assert pt.eval_loader.adj_format == eval_fmt
    for split in ("val", "test"):
        g = ppi["graphs"][split]
        got = pt.full_forward(_port_data(g))
        assert got.shape == (g.num_nodes, g.num_classes)
        np.testing.assert_allclose(got, ppi["want"][split], atol=1e-4, rtol=0,
                                   err_msg=split)


def test_full_forward_on_the_training_graph_is_the_fill(ppi):
    pt = ppi["port_trainer"]("hybrid")
    fill = pt.fill_history()
    plan = dict(pt.model._last_refresh_plan)
    state = [t.clone() for t in (*pt.hist.emb, *pt.hist.emb_ag, pt.out_table)]
    ff = pt.full_forward(_port_data(ppi["graphs"]["train"]))
    np.testing.assert_allclose(ff[pt.perm], fill, rtol=2e-4, atol=2e-4)
    assert pt.model._last_refresh_plan == plan and plan["global_cols"]
    for a, b in zip(state, (*pt.hist.emb, *pt.hist.emb_ag, pt.out_table)):
        assert torch.equal(a, b)


def _cli(*args):
    return main(["--model", SAGE_YAML, "--device", "cpu", *args])


def test_cli_reports_val_test_from_the_separate_graphs():
    res = _cli("--dataset", "sbm-ppi", "num_parts=4", "batch_size=2", "epochs=3")
    last = res["epochs"][-1]
    assert {"inductive_fill", "inductive0", "inductive2"} <= set(res["launches"])
    assert res["phases"]["inductive_s"] > 0 and last["inductive_s"] > 0
    # the training graph has no val/test node: these come from the others
    assert res["best_val"] == max(e["val_acc"] for e in res["epochs"]) > 0.5
    assert last["test_acc"] > res["fill"]["test_acc"]


def test_cli_on_a_converted_ppi_archive(tmp_path, capsys):
    graphs = {s: T_ds.make_sbm_inductive(split=s, **SPLITS)[0]
              for s in ("train", "val", "test")}
    raw = tmp_path / "raw"
    os.makedirs(raw)
    write_ppi_raw(str(raw), graphs)
    T_conv.main(["--format", "ppi", "--src", str(raw),
                 "--out", str(tmp_path / "ppi" / "data.npz")])
    capsys.readouterr()
    for split, g in graphs.items():
        d, _, _ = T_ds.get_data(str(tmp_path), "ppi", split=split)
        for a, b in ((d.adj_t.rowptr, g.adj_t.rowptr), (d.adj_t.col, g.adj_t.col),
                     (d.x, g.x), (d.y, g.y), (d.val_mask, g.val_mask)):
            assert np.array_equal(a, b), split
    res = _cli("--dataset", "ppi", "--root", str(tmp_path), "hidden_channels=32",
               "num_parts=4", "batch_size=2", "epochs=2")
    assert "inductive1" in res["launches"]
    assert all(0.0 < e["val_acc"] <= 1.0 and 0.0 < e["test_acc"] <= 1.0
               for e in res["epochs"])


def test_spill_with_an_inductive_dataset_is_refused():
    with pytest.raises(NotImplementedError, match="--spill with the inductive"):
        _cli("--dataset", "sbm-ppi", "--spill", "epochs=1")
