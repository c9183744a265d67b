"""Historical-embedding caches as device tensors.

Port of ``incagg_gnn_tpu/history.py``.  Per layer ``l``, ``emb[l]`` holds
the input of layer ``l`` (``M_in``) and ``emb_ag[l]`` its aggregation over
each node's full neighborhood (``M_ag``) — the two operands of the
incremental-aggregation rule ``h = A @ (x - M_in) + M_ag``.  Each table is
``[N+1, D]``; row ``N`` is a zero trash row that padded batch positions
gather from and write to.

Unlike the JAX package, whose caches are immutable arrays threaded through
jitted steps, :func:`push` writes into the table **in place**
(``index_copy_``): the tables are the largest state of a run and a copy per
push would double their traffic.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

#: cache dtypes by config name (hist_dtype / x_dtype)
CACHE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in CACHE_DTYPES:
        raise ValueError(
            f"unknown cache dtype {name!r}; one of {sorted(CACHE_DTYPES)}")
    return CACHE_DTYPES[name]


class HistoryState(NamedTuple):
    """Per-layer ``M_in`` (``emb``) and ``M_ag`` (``emb_ag``) tables, each a
    list of ``num_layers`` tensors ``[num_nodes + 1, dim]``."""

    emb: List[torch.Tensor]
    emb_ag: List[torch.Tensor]

    @property
    def num_layers(self) -> int:
        return len(self.emb)

    @property
    def num_nodes(self) -> int:
        return self.emb[0].shape[0] - 1

    @property
    def dim(self) -> int:
        return self.emb[0].shape[1]


def init_history(num_layers: int, num_nodes: int, dim: int,
                 dtype: torch.dtype, device) -> HistoryState:
    """Zero-initialized caches (reference: history.py:25-26)."""
    shape = (num_nodes + 1, dim)
    return HistoryState(
        emb=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
        emb_ag=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
    )


def pull(table: torch.Tensor, n_id: torch.Tensor) -> torch.Tensor:
    """Gather rows ``n_id`` of a cache table, upcast to f32 (reference:
    history.py:33-39 ``History.pull``)."""
    return table.index_select(0, n_id).float()


@torch.no_grad()
def push(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> None:
    """Write ``values`` into rows ``idx`` of ``table`` in place (padded
    entries point at the trash row).  No gradient flows into the cache."""
    values = values.detach().to(table.dtype)
    if table.element_size() == 1:
        # torch has no index_copy_ for float8: copy the bytes
        table, values = table.view(torch.uint8), values.view(torch.uint8)
    table.index_copy_(0, idx.long(), values)


@torch.no_grad()
def reset_trash_row(state: HistoryState) -> None:
    """Re-zero the trash row of every table, in place."""
    for t in (*state.emb, *state.emb_ag):
        t[-1].zero_()
