"""Small configurations of the cells' models on ``sbm-tiny``'s graph (400
nodes, 4 classes, 16 features, degree 8) and a ``BENCHMARK.json``-shaped
description of their cells, for the CPU tests."""

from __future__ import annotations

import json
import os

from port_bench import run

GRAPH = {"num_nodes": 400, "num_classes": 4, "num_features": 16, "avg_degree": 8.0,
         "data_seed": 0}

CONFIGS = {
    "gcn2": {"name": "gcn2-tiny", "model": "GCN2", "reference": "gcn2",
             "architecture": {"num_layers": 3, "hidden_channels": 16, "dropout": 0.2,
                              "drop_input": True, "batch_norm": True, "residual": False,
                              "shared_weights": False, "alpha": 0.1, "theta": 0.5},
             "trainer": {"num_parts": 4, "batch_size": 1, "max_steps": -1, "lr": 0.01,
                         "reg_weight_decay": 0.0, "nonreg_weight_decay": 0.0,
                         "grad_norm": None, "epochs": 3, "loop": True, "norm": True},
             "partition_seed": 0, "graph": GRAPH},
    "pna": {"name": "pna-tiny", "model": "PNA", "reference": "pna",
            "architecture": {"num_layers": 3, "hidden_channels": 16, "dropout": 0.3,
                             "drop_input": False, "batch_norm": True, "residual": False,
                             "aggregators": ["mean", "max", "min", "sum"],
                             "scalers": ["identity", "amplification", "attenuation"]},
            "trainer": {"num_parts": 8, "batch_size": 4, "max_steps": -1, "lr": 0.005,
                        "reg_weight_decay": 0.0, "nonreg_weight_decay": 0.0,
                        "grad_norm": 1.0, "epochs": 3, "loop": False, "norm": False},
            "partition_seed": 0, "graph": GRAPH},
}

#: the tiny cells' limits, by model, over the fill and two epochs.  GCNII's
#: sound runs read 1e-7 to 1e-5 on the CPU, PNA's up to 1e-2 in ``grad``,
#: ``change`` and ``refresh`` (a max or min aggregator's argument flips with
#: the round-off, and two epochs of Adam carry it on); the planted faults
#: read 1.3e-3 (GCNII's half-batch loss) and 0.15 to 1 in the others
LIMITS = {
    "gcn2": {"schedule": 0.0, "fill": 1e-4, "loss": 1e-4, "grad": 1e-3, "change": 1e-4,
             "refresh": 1e-4},
    "pna": {"schedule": 0.0, "fill": 1e-4, "loss": 1e-4, "grad": 3e-2, "change": 3e-2,
            "refresh": 3e-2},
}


def bench(tmp: str, model: str, **arch):
    """(a benchmark description holding the tiny model's GAS and Reverb
    cells, the configuration's name); ``arch`` overrides keys of the
    model's architecture."""
    cfg = dict(CONFIGS[model])
    cfg["architecture"] = {**cfg["architecture"], **arch}
    path = os.path.join(tmp, f"{cfg['name']}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": cfg["name"], "file": path}]
    b["workloads"] = [{"name": f"{cfg['name']}.{t}", "config": cfg["name"], "traffic": t,
                       "chips": 1} for t in ("gas", "reverb")]
    return b, cfg["name"]
