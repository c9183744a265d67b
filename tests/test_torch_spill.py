"""The port's spill tier (``incagg_gnn_tpu_torch/history_spill.py``) against
synchronous numpy gathers and scatters, as ``tests/test_spill.py`` holds the
JAX package's: pulls, FIFO-pipelined pulls, chunked and indexed pushes,
pull after push, slot reuse, growth past the buffer size, and the worker
library built into ``build/``.

The ``cuda``-marked tests skip without a CUDA device; on the card they
check the pinned staging under ``debug_verify`` over many pipelined pulls,
device pushes followed by pulls, and a spill epoch equal to the
device-cache epoch on sbm-small.  This file imports no JAX, so the card
runs it with ``pytest --noconftest -m cuda tests/test_torch_spill.py``."""

import os

import numpy as np
import pytest
import torch

from incagg_gnn_tpu_torch import history_spill
from incagg_gnn_tpu_torch.history_spill import SpilledHistory, spill_lib

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _table(rng, n, d, **kw):
    h = SpilledHistory(n, d, **kw)
    h.table[:] = rng.standard_normal((n + 1, d)).astype(np.float32)
    return h


def test_pull_roundtrip(rng):
    h = _table(rng, 1000, 32, pool_size=2, buffer_size=256)
    idx = rng.choice(1000, 200, replace=False)
    h.async_pull(idx)
    out = h.synchronize_pull()
    h.free_pull()
    assert out.dtype == torch.float32 and out.shape == (200, 32)
    assert np.array_equal(out.numpy(), h.table[idx])


def test_pipelined_pulls_fifo(rng):
    h = _table(rng, 500, 16, pool_size=3, buffer_size=128)
    idx = [rng.choice(500, k, replace=False) for k in (100, 50, 128)]
    for i in idx:
        h.async_pull(i)
    with pytest.raises(AssertionError, match="pool exhausted"):
        h.async_pull(idx[0])
    for i in idx:
        assert np.array_equal(h.synchronize_pull().numpy(), h.table[i])
        h.free_pull()


def test_slots_are_reused_in_order(rng):
    """Many pulls through two slots, each checked by ``debug_verify``
    against a synchronous gather, into caller-given outputs."""
    h = _table(rng, 300, 8, pool_size=2, buffer_size=64, debug_verify=True)
    h.async_pull(rng.choice(300, 64, replace=False))
    for _ in range(20):
        nxt = rng.choice(300, 40, replace=False)
        h.async_pull(nxt)
        _, n, idx = h._queue[0]
        out = torch.full((n + 3, 8), -1.0)
        h.synchronize_pull(out=out[:n])
        h.free_pull()
        assert np.array_equal(out[:n].numpy(), h.table[idx])
        assert (out[n:] == -1.0).all()
    h.synchronize_pull()
    h.free_pull()


def test_push_chunks(rng):
    h = SpilledHistory(300, 8, pool_size=2, buffer_size=128)
    vals = rng.standard_normal((60, 8)).astype(np.float32)
    offset, count = np.array([10, 100, 250]), np.array([20, 30, 10])
    h.async_push(torch.from_numpy(vals), offset=offset, count=count)
    h.synchronize_push()
    s = 0
    for o, c in zip(offset, count):
        assert np.array_equal(h.table[o:o + c], vals[s:s + c])
        s += c
    assert not h.table[:10].any() and not h.table[30:100].any()


def test_push_indexed(rng):
    h = SpilledHistory(300, 8, pool_size=2, buffer_size=128)
    idx = rng.choice(300, 40, replace=False)
    vals = rng.standard_normal((40, 8)).astype(np.float32)
    h.async_push(vals, idx=idx)
    h.synchronize_push()
    assert np.array_equal(h.table[idx], vals)


def test_pull_after_push_sees_new_values(rng):
    """A pull queued after a push reads the pushed rows: one FIFO worker,
    no ``synchronize_push`` between them."""
    h = SpilledHistory(100, 4, pool_size=2, buffer_size=64)
    vals = rng.standard_normal((10, 4)).astype(np.float32)
    idx = np.arange(10)
    for rep in range(3):  # the push buffers rotate
        h.async_push(vals + rep, idx=idx)
        h.async_pull(idx)
        assert np.array_equal(h.synchronize_pull().numpy(), vals + rep)
        h.free_pull()
    h.synchronize_push()


def test_buffers_grow_past_buffer_size(rng):
    h = _table(rng, 500, 4, pool_size=2, buffer_size=16)
    idx = rng.choice(500, 300, replace=False)
    h.async_pull(idx)
    assert np.array_equal(h.synchronize_pull().numpy(), h.table[idx])
    h.free_pull()
    vals = rng.standard_normal((300, 4)).astype(np.float32)
    h.async_push(vals, idx=idx)
    h.synchronize_push()
    assert np.array_equal(h.table[idx], vals)
    assert h.bytes_h2d == h.bytes_d2h == 300 * 4 * 4


def test_tables_take_their_own_slots(rng):
    a, b = _table(rng, 50, 4), _table(rng, 50, 4)
    assert a._base != b._base
    ia, ib = np.arange(5), np.arange(10, 20)
    a.async_pull(ia)
    b.async_pull(ib)
    assert np.array_equal(b.synchronize_pull().numpy(), b.table[ib])
    assert np.array_equal(a.synchronize_pull().numpy(), a.table[ia])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("dim", [5, 8])
def test_narrow_dtype_tables(rng, dtype, dim):
    """A table in a cache dtype narrower than f32 (the sharded spill tier's):
    each row padded to whole 4-byte words for the worker; pushes (chunked,
    indexed, whole-table) store the values converted to the dtype, pulls
    return the stored rows, their padding zero."""
    h = SpilledHistory(50, dim, pool_size=2, buffer_size=4, dtype=dtype)
    assert h.cols % (4 // h.itemsize) == 0 and h.cols >= dim
    vals = torch.from_numpy(rng.standard_normal((10, dim)).astype(np.float32))
    h.async_push(vals, offset=np.array([3, 20]), count=np.array([6, 4]))
    h.async_push(vals[:2] * 2, idx=np.array([40, 41]))
    h.synchronize_push()
    h.async_pull(np.array([23, 3, 41]))
    out = h.synchronize_pull()
    h.free_pull()
    assert out.dtype == dtype and out.shape == (3, h.cols)
    want = torch.stack([vals[9], vals[0], vals[1] * 2]).to(dtype)
    assert torch.equal(out[:, :dim].view(torch.uint8), want.view(torch.uint8))
    assert not out[:, dim:].float().any()
    assert h.bytes_h2d == 3 * h.cols * h.itemsize
    whole = torch.from_numpy(rng.standard_normal((51, dim)).astype(np.float32))
    h.push_table(whole)
    assert torch.equal(h.table_t[:, :dim].view(torch.uint8),
                       whole.to(dtype).view(torch.uint8))


def test_worker_library_is_built_into_build_dir():
    assert spill_lib() is not None
    so = history_spill._SO
    assert os.path.dirname(so).endswith("build") and os.path.exists(so)
    assert os.path.getmtime(so) >= os.path.getmtime(history_spill._SRC)


# ---------------- on the card ----------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_pinned_pipelined_pulls_verified(cuda, rng):
    h = _table(rng, 20000, 128, pool_size=3, buffer_size=4096,
               device=cuda, debug_verify=True)
    assert h.table_t.is_pinned() and h._staging_t[0].is_pinned()
    idx = [rng.choice(20000, 4096, replace=False) for _ in range(40)]
    for j in range(2):
        h.async_pull(idx[j])
    for i in range(40):
        if i + 2 < 40:
            h.async_pull(idx[i + 2])
        out = h.synchronize_pull()
        h.free_pull()
        assert out.is_cuda
        torch.testing.assert_close(out.cpu(), torch.from_numpy(h.table[idx[i]]),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_device_push_then_pull(cuda, rng):
    h = SpilledHistory(5000, 64, pool_size=2, buffer_size=1024, device=cuda)
    idx = rng.choice(5000, 1000, replace=False)
    for rep in range(4):
        vals = torch.randn(1000, 64, device=cuda) + rep
        h.async_push(vals * 2.0, idx=idx)  # a kernel just queued
        h.async_pull(idx)
        got = h.synchronize_pull()
        h.free_pull()
        torch.testing.assert_close(got, vals * 2.0, rtol=0, atol=0)
    h.synchronize_push()


@pytest.mark.cuda
@pytest.mark.parametrize("vr", [False, True])
def test_spill_epoch_equals_device_cache_epoch(cuda, vr):
    from incagg_gnn_tpu_torch.graph.datasets import make_sbm
    from incagg_gnn_tpu_torch.models.gcn import GCN, GCNConfig
    from incagg_gnn_tpu_torch.train.spill_trainer import SpillVRTrainer
    from incagg_gnn_tpu_torch.train.trainer import Trainer, TrainerConfig

    data, in_c, out_c = make_sbm(num_nodes=2000, num_classes=8, num_features=32,
                                 avg_degree=10.0, seed=2)
    cfg = GCNConfig(num_nodes=data.num_nodes, in_channels=in_c, hidden_channels=32,
                    out_channels=out_c, num_layers=3, dropout=0.0, drop_input=False)
    tcfg = TrainerConfig(num_parts=8, batch_size=2, vr_update=vr, seed=0,
                         adj_format="hybrid")
    a = Trainer(GCN(cfg, generator=torch.Generator().manual_seed(0)), data, tcfg, cuda)
    b = SpillVRTrainer(GCN(cfg, generator=torch.Generator().manual_seed(0)), data,
                       tcfg, cuda, debug_verify=True)
    np.testing.assert_allclose(b.fill_history(), a.fill_history(), atol=1e-4, rtol=0)
    la, lb = a.train_epoch()["loss"], b.train_epoch()["loss"]
    assert abs(la - lb) <= 1e-5 * abs(la), (la, lb)
    ea, eb = a.evaluate(), b.evaluate()
    assert abs(ea["val_acc"] - eb["val_acc"]) <= 1e-4
    for l in range(1, 3):
        torch.testing.assert_close(b.spill_in[l].table_t[:-1],
                                   a.hist.emb[l][:-1].cpu(), rtol=0, atol=1e-4)
