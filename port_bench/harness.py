"""The system under test: the port's ``Trainer``, built for a cell as the
port's CLI builds it (``incagg_gnn_tpu_torch/__main__.py``), and the taps
that record what its timed path fed each step.

From the port the benchmark takes only its graph containers, its model
constructor and its ``Trainer``; ``train_epoch()`` and ``evaluate()`` are
the calls the window drives.  The partition and the training batches'
grouping and order are drawn from the configuration's fixed
``partition_seed``: every seed trains on the same batches, so no seed
changes the work (a user's graph is partitioned the same way from job to
job).  ``--seed`` gives the weights and the dropout generator.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch


def trainer_config(cfg: Dict, traffic: Dict):
    """The port's ``TrainerConfig`` of a cell: the configuration's trainer
    block, the traffic's overrides, the partition seed."""
    from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    kw = {k: v for k, v in {**cfg["trainer"], **traffic.get("trainer", {})}.items()
          if k in fields}
    kw["seed"] = cfg["partition_seed"]
    return TrainerConfig(**kw)


def build(cfg: Dict, traffic: Dict, graph: Dict[str, np.ndarray], seed: int, device,
          make_weights) -> tuple:
    """The port's trainer of the cell, its weights set from
    ``make_weights(shapes)``; returns ``(trainer, weights)``."""
    from incagg_gnn_tpu_torch.__main__ import build_model
    from incagg_gnn_tpu_torch.graph.csr import CSRGraph, GraphData
    from incagg_gnn_tpu_torch.train.config import RunConfig
    from incagg_gnn_tpu_torch.train.trainer import Trainer

    data = GraphData(adj_t=CSRGraph(graph["rowptr"], graph["col"], None), x=graph["x"],
                     y=graph["y"], train_mask=graph["train_mask"],
                     val_mask=graph["val_mask"], test_mask=graph["test_mask"])
    tcfg = trainer_config(cfg, traffic)
    run_cfg = RunConfig(model=cfg["model"], dataset=cfg["name"],
                        architecture=dict(cfg["architecture"]), trainer=tcfg)
    in_c, out_c = data.num_features, data.num_classes
    model = build_model(run_cfg, data, in_c, out_c, seed)
    trainer = Trainer(model, data, tcfg, device)
    trainer.generator.manual_seed(seed)
    shapes = {k: tuple(p.shape) for k, p in trainer.model.named_parameters()}
    weights = make_weights(shapes)
    with torch.no_grad():
        for k, p in trainer.model.named_parameters():
            p.copy_(weights[k])
    return trainer, weights


class Tap:
    """Records, per epoch, each training batch's columns as the loader
    yielded it (``n_id``: program row ids, in-batch first) and, with
    ``masks``, the loss of each step that runs eagerly (every step of a
    looped epoch; of a fused epoch on the card only the first, since the
    others are replays of its capture) and the dropout masks the epoch's
    steps drew, in draw order:
    every call of the model module's ``dropout`` in training with a rate
    above 0 records where its output is nonzero.  The calls return what
    they returned.  Nothing is recorded while a CUDA graph is captured, so
    no op of the tap's enters the graphs the window replays; a replay
    draws its masks on the card unseen, so a fused epoch with dropout
    records too few masks, which the check counts as a fault."""

    def __init__(self, trainer, masks: bool):
        self.trainer = trainer
        self.epochs: List[List[tuple]] = []
        self.masks: List[List[torch.Tensor]] = []
        self.losses: List[List[torch.Tensor]] = []
        self._orig_batches = trainer._train_batches
        trainer._train_batches = self._batches
        self._mod, self._orig_dropout, self._orig_step = None, None, None
        self._made = {}
        self.active = True
        if masks:
            self._orig_step = trainer.step
            trainer.step = self._step
            self._mod = sys.modules[type(trainer.model).__module__]
            self._orig_dropout = self._mod.dropout
            self._mod.dropout = self._dropout
            tmod = sys.modules[type(trainer).__module__]
            for name in ("make_gas_epoch_graph", "make_vr_epoch_graph"):
                self._made[name] = getattr(tmod, name)
                setattr(tmod, name, self._epoch_graph(self._made[name]))

    def new_epoch(self) -> None:
        self.epochs.append([])
        self.masks.append([])
        self.losses.append([])

    def _step(self, hb, staged=None):
        out = self._orig_step(hb, staged)
        self.losses[-1].append(out["loss"])
        return out

    def _epoch_graph(self, make):
        """``make`` with the made fused epoch's loss recorded at each step
        that runs eagerly; inside a capture nothing is computed yet."""
        def made(*args, **kw):
            graph = make(*args, **kw)
            inner = graph.loss_fn

            def loss_fn(batch):
                loss, n = inner(batch)
                capturing = loss.is_cuda and torch.cuda.is_current_stream_capturing()
                if self.active and self.losses and not capturing:
                    self.losses[-1].append(loss.detach().clone())
                return loss, n
            graph.loss_fn = loss_fn
            return graph
        return made

    def _batches(self):
        it = self._orig_batches()
        try:
            for hb, staged in it:
                if self.epochs:
                    self.epochs[-1].append((hb.n_id, hb.batch_size))
                yield hb, staged
        finally:
            it.close()

    def _dropout(self, x, p, training, generator):
        out = self._orig_dropout(x, p, training, generator)
        capturing = out.is_cuda and torch.cuda.is_current_stream_capturing()
        if training and p > 0.0 and generator is not None and self.masks and not capturing:
            self.masks[-1].append(out != 0)
        return out

    def remove(self) -> None:
        self.active = False
        self.trainer._train_batches = self._orig_batches
        tmod = sys.modules[type(self.trainer).__module__]
        for name, make in self._made.items():
            setattr(tmod, name, make)
        if self._orig_step is not None:
            self.trainer.step = self._orig_step
        if self._mod is not None:
            self._mod.dropout = self._orig_dropout


def exp_avg(trainer) -> Dict[str, torch.Tensor]:
    """Adam's first moment of every parameter, by name (zeros before a step)."""
    out = {}
    for k, p in trainer.model.named_parameters():
        st = trainer.opt.adam.state.get(p, {})
        out[k] = (st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)).detach().cpu().clone()
    return out


def tables(trainer) -> Dict[str, torch.Tensor]:
    """The caches and the logits table, by name, without the trash row."""
    out = {f"M_in.{l}": t[:-1] for l, t in enumerate(trainer.hist.emb)}
    out.update({f"M_ag.{l}": t[:-1] for l, t in enumerate(trainer.hist.emb_ag)})
    out["logits"] = trainer.out_table[:-1]
    return out


def cache_bytes(trainer) -> int:
    return sum(t.numel() * t.element_size() for t in (*trainer.hist.emb, *trainer.hist.emb_ag))


def eval_batches(trainer) -> List[np.ndarray]:
    """The eval (refresh) batches' in-batch rows, program row ids."""
    ptr = trainer.eval_loader.ptr
    return [np.arange(ptr[i], ptr[i + 1]) for i in range(len(ptr) - 1)]


def launches() -> Dict[str, int]:
    from incagg_gnn_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def build_kernels() -> Optional[float]:
    """Build (or find) the port's CUDA kernel library; seconds spent."""
    from incagg_gnn_tpu_torch.ops import kernels

    t = kernels.build_kernels()
    kernels._lib()
    return t
