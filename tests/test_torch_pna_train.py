"""One training epoch of the JAX package's trainer and the port's, for PNA
in GAS, VR mock and VR ``true_vr`` mode and PNA_JK in GAS mode, on the
hybrid pair, with the ``sbm-small`` block of ``conf/model/pna.yaml`` (mean
and max, identity scaler), dropout 0 and JAX-initialised parameters carried
over by ``load_pna_params`` / ``load_pna_jk_params``: the fill's logits and
caches within 1e-4, the epoch's loss and drift within rtol 1e-4.  Apart
from ``test_torch_pna.py`` so that the two files, each bound by the JAX
package's compiles, run on two workers."""

import jax
import numpy as np
import pytest
import torch

from incagg_gnn_tpu.models import pna as J_pna
from incagg_gnn_tpu.models import pna_jk as J_pna_jk
from incagg_gnn_tpu_torch.convert import load_pna_jk_params, load_pna_params
from incagg_gnn_tpu_torch.models import pna as T_pna
from incagg_gnn_tpu_torch.models import pna_jk as T_pna_jk
from test_torch_gat import _port_data
from test_torch_native import jax_native_reference  # noqa: F401 (module fixture)

torch.set_num_threads(2)
ATOL = 1e-4
#: the sbm-small block of conf/model/pna.yaml, dropout 0
SMALL = dict(num_layers=2, hidden_channels=32, dropout=0.0, drop_input=False,
             batch_norm=False, residual=False, aggregators=("mean", "max"),
             scalers=("identity",))


@pytest.mark.parametrize("model,vr,true_vr", [
    ("PNA", False, False), ("PNA", True, False), ("PNA", True, True), ("PNA_JK", False, False),
], ids=["pna-gas", "pna-vr-mock", "pna-vr-true", "pna_jk-gas"])
def test_epoch_matches_jax(sbm_small, model, vr, true_vr):
    """The fill's logits and caches (the trash row left out: the JAX
    package's PNA_JK refresh writes padded rows there) within 1e-4, and
    one epoch's loss (4 Adam steps from the same parameters, rtol 1e-4) of
    the JAX trainer and the port's, on the hybrid pair."""
    from incagg_gnn_tpu.train.trainer import Trainer as JTrainer
    from incagg_gnn_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig

    data, in_c, out_c = sbm_small
    lin, log = T_pna.compute_avg_deg(data.adj_t.degrees())
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c, **SMALL,
               avg_deg_lin=lin, avg_deg_log=log, true_vr=true_vr)
    if model == "PNA":
        jm, jc, tm, tc, load = (J_pna.PNA, J_pna.PNAConfig, T_pna.PNA, T_pna.PNAConfig,
                                load_pna_params)
    else:
        jm, jc, tm, tc, load = (J_pna_jk.PNA_JK, J_pna_jk.PNAJKConfig, T_pna_jk.PNA_JK,
                                T_pna_jk.PNAJKConfig, load_pna_jk_params)
    kw = dict(num_parts=8, batch_size=2, lr=0.01, epochs=1, seed=0, adj_format="hybrid",
              vr_update=vr, loop=False, norm=False, fused_epoch="off", grad_norm=1.0)
    jt = JTrainer(jm(jc(**cfg)), data, JTrainerConfig(**kw))
    pt = Trainer(tm(tc(**cfg)), _port_data(data), TrainerConfig(**kw), "cpu")
    load(pt.model, jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.state))
    assert pt.model.hist_dim == jt.model.hist_dim
    np.testing.assert_allclose(pt.fill_history(), jt.fill_history(), atol=ATOL, rtol=0)
    for tab, jtab in zip((*pt.hist.emb, *pt.hist.emb_ag), (*jt.hist.emb, *jt.hist.emb_ag)):
        np.testing.assert_allclose(tab[:-1].numpy(), np.asarray(jtab)[:-1], atol=ATOL, rtol=0)
    want, got = jt.train_epoch(), pt.train_epoch()
    assert got["steps"] == want["steps"] == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["drift"], want["drift"], rtol=1e-4, atol=1e-6)
