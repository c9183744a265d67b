"""The yardstick's counts against hand counts on a small graph."""

import numpy as np
import pytest

from port_bench import counts
from port_bench.graphgen import _csr_from_coo
from port_bench.reference import gcn2, pna

# a path 0-1-2-3-4 and an edge 0-4: a ring of five
EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)]


@pytest.fixture(scope="module")
def ring():
    src = np.array([a for a, b in EDGES] + [b for a, b in EDGES])
    dst = np.array([b for a, b in EDGES] + [a for a, b in EDGES])
    return _csr_from_coo(src, dst, 5)


def test_batch_shape(ring):
    rowptr, col = ring
    # rows {0, 1}: neighbours 1, 4 and 0, 2; columns {0, 1, 2, 4}
    assert counts.batch_shape(rowptr, col, np.array([0, 1]), False) == \
        counts.BatchShape(rows=2, cols=4, nnz=4, nnz_ib=2)
    # with self-loops: two more entries, both in-batch
    assert counts.batch_shape(rowptr, col, np.array([0, 1]), True) == \
        counts.BatchShape(rows=2, cols=4, nnz=6, nnz_ib=4)
    assert counts.batch_shape(rowptr, col, np.arange(5), False) == \
        counts.BatchShape(rows=5, cols=5, nnz=10, nnz_ib=10)


def test_agg_work_and_bound():
    ops, nbytes = counts.agg_work(nnz=6, rows_in=4, rows_out=2, d=8)
    assert ops == 2 * 6 * 8
    assert nbytes == 6 * 8 + 4 * 8 * 4 + 2 * 8 * 4
    pk = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.agg_bound_s(6, 4, 2, 8, pk) == pytest.approx(nbytes / 3.35e12)
    # wide enough rows make the operations the bound
    big = counts.agg_bound_s(10**6, 1, 1, 10**5, pk)
    assert big == pytest.approx(2 * 10**6 * 10**5 / 67e12)
    assert counts.peaks("a card not listed") is None


def test_gcn2_step_work():
    arch = {"num_layers": 2, "hidden_channels": 4, "shared_weights": False}
    shape = counts.BatchShape(rows=2, cols=4, nnz=6, nnz_ib=4)
    gemm, fwd, bwd = gcn2.step_work(arch, in_c=3, out_c=5, shape=shape, vr=False)
    # lins.0 on every column, two [4, 4] GEMMs a layer on the rows, lins.1
    assert gemm == 2 * 4 * 3 * 4 + 2 * 2 * (2 * 2 * 4 * 4) + 2 * 2 * 4 * 5
    assert fwd == [(6, 4, 2, 4)] * 2
    assert bwd == [(6, 2, 4, 4), (4, 2, 2, 4)]
    gemm, fwd, bwd = gcn2.step_work(arch, 3, 5, shape, vr=True)
    assert fwd == [(4, 2, 2, 4)] * 2 and bwd == [(4, 2, 2, 4)] * 2


def test_pna_work():
    arch = {"num_layers": 1, "hidden_channels": 4, "aggregators": ["mean", "max"],
            "scalers": ["identity", "attenuation"]}
    shape = counts.BatchShape(rows=2, cols=4, nnz=6, nnz_ib=4)
    gemm, fwd, bwd = pna.step_work(arch, in_c=3, out_c=5, shape=shape, vr=False)
    # four branches of width 5: pre on the columns, post and root on the rows
    assert gemm == 2 * 4 * 3 * 4 * 5 + 2 * 2 * 4 * 5 * 5 + 2 * 2 * 3 * 5
    assert fwd == [(6, 4, 2, 10), (6, 4, 2, 10)] and bwd == [(6, 2, 4, 10)] * 2
    g, aggs = pna.refresh_work(arch, 3, 5, [shape], vr=False, num_nodes=7)
    assert g == 2 * 7 * 3 * 4 * 5 + 2 * 2 * 4 * 5 * 5 + 2 * 2 * 3 * 5
    assert aggs == [(6, 4, 2, 10), (6, 4, 2, 10)]


def test_pna_stacked_order():
    arch = {"aggregators": ["mean", "max", "min", "sum"],
            "scalers": ["identity", "amplification"]}
    assert pna.stacked(arch) == [
        ("mean", "identity"), ("mean", "amplification"), ("sum", "identity"),
        ("sum", "amplification"), ("max", "identity"), ("max", "amplification"),
        ("min", "identity"), ("min", "amplification")]
