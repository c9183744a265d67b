"""The port's batch prefetch (``utils/prefetch.py``) and its use in the
train loop: items come in order, at most ``depth`` ahead; an error of the
source is raised again in the consumer; a consumer that stops early leaves
no live worker and closes the source; and a prefetched training run gives
bit for bit the losses and parameters of the same run iterated in line
(GCN with dropout on the block format, GAT on the hybrid pair), also when
``max_steps`` cuts the epoch."""

import threading
import time

import numpy as np
import pytest
import torch

from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.models.gat import GAT, GATConfig
from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
from incagg_gnn_tpu_torch.train import trainer as T_trainer
from incagg_gnn_tpu_torch.utils.prefetch import prefetch

torch.set_num_threads(2)


def _workers():
    return [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]


def test_items_in_order_at_most_depth_ahead():
    made = []

    def source():
        for i in range(20):
            made.append(i)
            yield i

    got = []
    for item in prefetch(source(), depth=2):
        time.sleep(0.005)
        # the worker holds at most `depth` queued items and one in hand
        assert len(made) - len(got) <= 2 + 2
        got.append(item)
    assert got == list(range(20))
    assert not _workers()


def test_error_in_the_worker_is_raised_in_the_consumer():
    def source():
        yield 1
        raise KeyError("collate failed")

    it = prefetch(source(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="collate failed"):
        next(it)
    assert not _workers()


def test_early_stop_joins_the_worker_and_closes_the_source():
    closed = threading.Event()

    def source():
        try:
            for i in range(1000):
                yield i
        finally:
            closed.set()

    for i in prefetch(source(), depth=2):
        if i == 3:
            break
    assert closed.is_set() and not _workers()


def _inline(it, depth):
    """The train loop's iterator without the thread."""
    yield from it


def _port_data(data):
    return T_csr.GraphData(
        adj_t=T_csr.CSRGraph(data.adj_t.rowptr, data.adj_t.col, data.adj_t.value),
        x=data.x, y=data.y, train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def _run(sbm, model, epochs, **kw):
    data, in_c, out_c = sbm
    cfg = dict(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c)
    if model == "GCN":
        m = GCN(GCNConfig(num_layers=2, hidden_channels=16, dropout=0.3, **cfg),
                generator=torch.Generator().manual_seed(0))
    else:
        m = GAT(GATConfig(num_layers=2, hidden_channels=8, hidden_heads=2, dropout=0.2,
                          **cfg), generator=torch.Generator().manual_seed(0))
    t = T_trainer.Trainer(m, _port_data(data), T_trainer.TrainerConfig(
        num_parts=8, batch_size=2, epochs=epochs, seed=3, **kw), "cpu")
    t.fill_history()
    losses = [t.train_epoch()["loss"] for _ in range(epochs)]
    return losses, [p.detach().clone() for p in t.model.parameters()]


@pytest.mark.parametrize("model,kw", [
    ("GCN", dict(adj_format="block")),
    ("GAT", dict(adj_format="hybrid", max_steps=3)),
], ids=["gcn-block", "gat-hybrid-max-steps"])
def test_prefetched_epochs_equal_inline_ones(sbm_small, monkeypatch, model, kw):
    got, got_p = _run(sbm_small, model, 2, **kw)
    assert not _workers()
    monkeypatch.setattr(T_trainer, "prefetch", _inline)
    want, want_p = _run(sbm_small, model, 2, **kw)
    assert got == want and all(np.isfinite(got))
    for a, b in zip(got_p, want_p):
        assert torch.equal(a, b)


def test_refresh_of_a_host_held_set_equals_the_cached_one(sbm_small):
    """A refresh over an eval set held on the host (staged per layer, one
    batch ahead on the prefetch thread) writes the same caches and logits,
    bit for bit, as one over the set held on the device, also for a subset
    of its batches."""
    from incagg_gnn_tpu_torch.loader import EvalSubgraphLoader

    data, in_c, out_c = sbm_small
    tdata = _port_data(data)
    m = GCN(GCNConfig(num_nodes=data.num_nodes, in_channels=in_c, out_channels=out_c,
                      num_layers=3, hidden_channels=16),
            generator=torch.Generator().manual_seed(0))
    ptr = np.linspace(0, data.num_nodes, 9).astype(np.int64)
    x = torch.from_numpy(np.concatenate([data.x, np.zeros((1, in_c), np.float32)]))
    outs = []
    for device_cache in (True, False):
        loader = EvalSubgraphLoader(tdata, ptr, "cpu", adj_format="hybrid-fwd",
                                    device_cache=device_cache)
        hist = m.init_history(torch.float32, "cpu")
        logits, _ = m.refresh(x, loader, hist, vr=True)
        part, _ = m.refresh(x, loader, hist, subset=[5, 6, 0])
        held_on_host = isinstance(loader.cached()[0].device.n_id, np.ndarray)
        assert held_on_host == (not device_cache)
        outs.append((logits, part, [t.clone() for t in (*hist.emb, *hist.emb_ag)]))
    assert not _workers()
    (la, pa, ta), (lb, pb, tb) = outs
    assert np.array_equal(la, lb) and np.array_equal(pa, pb)
    assert all(torch.equal(a, b) for a, b in zip(ta, tb))
