"""The host-side helpers of ``incagg_gnn_tpu_torch/profile_agg.py`` that
its A/B parts rest on: the order of the turns, the compiler report's
registers and spills, a hybrid table's tail counts.  Plain Python on the
CPU: no card, no JAX."""

import numpy as np
import pytest
import torch

from incagg_gnn_tpu_torch import profile_agg as P
from incagg_gnn_tpu_torch.graph.csr import CSRGraph
from incagg_gnn_tpu_torch.ops.ell import build_hybrid_adj


@pytest.mark.parametrize("names,order", [
    (["parent", "change"], ["parent", "change", "change", "parent"]),
    (["a", "b", "c"], ["a", "b", "c", "c", "b", "a"]),
])
def test_turns_runs_contenders_forward_then_backward(monkeypatch, names, order):
    """Each contender is timed twice, by events and by replays, in the
    order parent, change, change, parent; every time is printed."""
    seen = []
    monkeypatch.setattr(P, "events_ms", lambda fn: fn() + 0.25)
    monkeypatch.setattr(P, "graph_ms", lambda fn: len(seen) + 0.0)

    def run(who):
        def fn():
            seen.append(who)
            return float(len(seen))
        return fn

    line = P.turns({who: run(who) for who in names})
    assert seen == order
    for i, who in enumerate(names):
        first, last = order.index(who), len(order) - 1 - order[::-1].index(who)
        assert (f"{who} events {first + 1.25:.4f} / {last + 1.25:.4f}, replays "
                f"{first + 1:.4f} / {last + 1:.4f} ms") in line


REPORT = """\
ptxas info    : Compiling entry function '_Z25ell_spmm_heads_vec_kernelILi2ELi4EEvPKiPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z25ell_spmm_heads_vec_kernelILi2ELi4EEvPKiPKfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19ell_spmm_vec_kernelILi2ELi2EEvPKiPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z19ell_spmm_vec_kernelILi2ELi2EEvPKiPKfS1_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, 432 bytes cmem[0]
"""


@pytest.mark.parametrize("pattern,lines", [
    ("ell_spmm_heads", ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                        "Used 64 registers, 432 bytes cmem[0]"]),
    ("ell_spmm", ["0 bytes spill stores", "Used 64 registers", "4 bytes spill stores",
                  "Used 80 registers"]),
    ("hybrid_max", []),
])
def test_print_ptxas_reports_the_matching_kernels(capsys, pattern, lines):
    P.print_ptxas("this tree", REPORT, pattern)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(lines)
    for got, want in zip(out, lines):
        assert got.startswith("    ptxas this tree: _Z") and want in got


@pytest.mark.parametrize("k", [0, 4, 40])
def test_tail_stats_counts_the_real_slots_and_the_tail(k):
    rng = np.random.default_rng(k)
    n = 300
    deg = rng.integers(0, 9, n)
    deg[::30] = 25
    row = np.repeat(np.arange(n), deg)
    g = CSRGraph.from_coo(row, rng.integers(0, n, row.size), n,
                          rng.random(row.size).astype(np.float32) + 0.5)
    h = build_hybrid_adj(g.rowptr, g.col, g.value, n, n, k=k, ovf_pad=4096).to("cpu")
    edges = np.diff(g.rowptr)  # duplicate edges merged
    tail = np.maximum(edges - h.ell_cols.shape[1], 0)
    assert P.tail_stats(h) == (f"{edges.sum() - tail.sum()} real ELL slots, tail "
                               f"{tail.sum()} entries on {(tail > 0).sum()} rows, "
                               f"longest {tail.max()}")
