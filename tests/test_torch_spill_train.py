"""The port's spill trainer (``incagg_gnn_tpu_torch/train/spill_trainer.py``)
against the JAX package's ``SpillVRTrainer`` and against the port's own
device-cache ``Trainer``, as ``tests/test_spill_trainer.py`` holds the JAX
one: GCN in VR and GAS, GCNII with its x0 (GAS and VR), and PNA with
``true_vr`` (its packed caches through ``StreamedPulls``), on sbm_tiny with
dropout off and the same weights in all three.  Tolerances: refresh logits
and host tables 1e-4, one epoch's loss 1e-5; the GAS pushed slots equal the
JAX trainer's (``[1]`` for a 2-layer GCN)."""

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import GCN as JGCN
from incagg_gnn_tpu.models import GCN2 as JGCN2
from incagg_gnn_tpu.models import PNA as JPNA
from incagg_gnn_tpu.models import GCN2Config as JGCN2Config
from incagg_gnn_tpu.models import GCNConfig as JGCNConfig
from incagg_gnn_tpu.models import PNAConfig as JPNAConfig
from incagg_gnn_tpu.models import compute_avg_deg
from incagg_gnn_tpu.train.spill_trainer import SpillVRTrainer as JSpill
from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
from incagg_gnn_tpu_torch.convert import load_params
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.models.gcn2 import GCN2, GCN2Config
from incagg_gnn_tpu_torch.models.pna import PNA, PNAConfig
from incagg_gnn_tpu_torch.train.spill_trainer import SpillVRTrainer
from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _models(name, data, in_c, out_c):
    """(JAX model, port model, port model) of one configuration."""
    base = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                dropout=0.0, drop_input=False)
    if name == "GCN":
        arch = dict(base, hidden_channels=16, num_layers=2)
        return JGCN(JGCNConfig(**arch)), GCN(GCNConfig(**arch)), GCN(GCNConfig(**arch))
    if name == "GCN2":
        arch = dict(base, hidden_channels=16, num_layers=3)
        return (JGCN2(JGCN2Config(**arch)), GCN2(GCN2Config(**arch)),
                GCN2(GCN2Config(**arch)))
    lin_d, log_d = compute_avg_deg(data.adj_t.degrees() + 1)
    arch = dict(base, hidden_channels=16, num_layers=2, true_vr=True,
                aggregators=("sum", "mean"), scalers=("identity",),
                avg_deg_lin=lin_d, avg_deg_log=log_d)
    return JPNA(JPNAConfig(**arch)), PNA(PNAConfig(**arch)), PNA(PNAConfig(**arch))


CASES = [("GCN", True), ("GCN", False), ("GCN2", False), ("GCN2", True), ("PNA", True)]


@pytest.mark.parametrize("name,vr", CASES, ids=[f"{n}-{'vr' if v else 'gas'}"
                                                 for n, v in CASES])
def test_spill_trainer_matches_jax_and_device_cache(sbm_tiny, name, vr):
    data, in_c, out_c = sbm_tiny
    jm, m_spill, m_dev = _models(name, data, in_c, out_c)
    # adj_format auto (the JAX spill tests' own): the JAX SpillVRTrainer
    # refreshes wrongly on an explicit hybrid format for the sum/mean
    # models, whose eval batches then index global columns (ROADMAP §3)
    kw = dict(num_parts=4, batch_size=2, vr_update=vr, seed=0)
    jt = JSpill(jm, data, JTrainerConfig(**kw))
    params = jax.tree.map(np.asarray, jt.params)
    state = jax.tree.map(np.asarray, jt.state)
    for m in (m_spill, m_dev):
        load_params(m, params, state)
    pdata = _port_data(data)
    st = SpillVRTrainer(m_spill, pdata, TrainerConfig(**kw), "cpu", debug_verify=True)
    dt = Trainer(m_dev, pdata, TrainerConfig(**kw), "cpu")
    n = data.num_nodes

    want = jt.fill_history()
    got = st.fill_history()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, dt.fill_history(), atol=1e-4, rtol=0)
    for l in range(len(st.spill_in)):
        # GAS: the JAX spill trainer keeps GCNII's x0 in a host array beside
        # its tables; the port keeps it in M_in[0]'s table, as its device
        # caches do
        ref = (dt.hist.emb[0][:n].numpy() if l == 0 and not vr
               else jt.spill_in[l].table[:n])
        np.testing.assert_allclose(st.spill_in[l].table[:n], ref,
                                   atol=1e-4, rtol=0, err_msg=f"M_in {l}")
    for l in range(len(st.spill_ag)):
        np.testing.assert_allclose(st.spill_ag[l].table[:n], jt.spill_ag[l].table[:n],
                                   atol=1e-4, rtol=0, err_msg=f"M_ag {l}")
    assert len(st.spill_ag) == (len(st.spill_in) if vr else 0)

    jl = jt.train_epoch()["loss"]
    sl = st.train_epoch()["loss"]
    dl = dt.train_epoch()["loss"]
    assert abs(sl - jl) <= 1e-5, (sl, jl)
    assert abs(sl - dl) <= 1e-5, (sl, dl)
    if not vr:
        assert st._gas_push_slots == jt._gas_push_slots
        if name == "GCN":
            assert st._gas_push_slots == [1]
        for l in st._gas_push_slots:  # the epoch's pushes reached the tables
            np.testing.assert_allclose(st.spill_in[l].table[:n],
                                       dt.hist.emb[l][:n].numpy(), atol=1e-4, rtol=0)
    ev = st.evaluate()
    assert abs(ev["val_acc"] - dt.evaluate()["val_acc"]) <= 1e-4


def test_spill_checkpoint_holds_the_host_tables(sbm_tiny, tmp_path):
    """The spill trainer's checkpoint carries its host tables (the JAX spill
    trainer's protocol) and restores them in place."""
    from incagg_gnn_tpu_torch.train.checkpoint import CheckpointManager

    data, in_c, out_c = sbm_tiny
    kw = dict(num_parts=4, batch_size=2, vr_update=True, seed=0)

    def trainer():
        _, m, _ = _models("GCN", data, in_c, out_c)
        return SpillVRTrainer(m, _port_data(data), TrainerConfig(**kw), "cpu")

    a = trainer()
    a.fill_history()
    a.train_epoch()
    a.evaluate()
    CheckpointManager(str(tmp_path)).save(a, 0)
    state = a.checkpoint_state()
    assert {"spill_in.0", "spill_in.1", "spill_ag.0", "spill_ag.1"} <= set(state)
    assert not any(k.startswith("hist.") for k in state)
    loss = a.train_epoch()["loss"]
    b = trainer()
    tables = [t.table for t in b.spill_in]
    assert CheckpointManager(str(tmp_path)).maybe_restore(b)
    for t, before in zip(b.spill_in, tables):
        assert t.table is before  # restored in place
    for k in ("spill_in.0", "spill_ag.1"):
        assert torch.equal(b.checkpoint_state()[k], state[k])
    b.fill_history()
    assert b.train_epoch()["loss"] == loss


def test_spill_refuses_what_it_lacks(sbm_tiny):
    data, in_c, out_c = sbm_tiny
    _, m, _ = _models("GCN", data, in_c, out_c)
    with pytest.raises(NotImplementedError, match="hist_momentum"):
        SpillVRTrainer(m, _port_data(data), TrainerConfig(num_parts=4, hist_momentum=0.5),
                       "cpu")
