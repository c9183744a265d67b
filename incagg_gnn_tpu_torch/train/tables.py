"""Device-resident full-graph tables with a zero trash row at index N, so
batches carry only indices (port of ``incagg_gnn_tpu/train/tables.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from incagg_gnn_tpu_torch.graph.csr import GraphData


class DeviceTables(NamedTuple):
    x: torch.Tensor  # [N+1, F] (row N = zeros)
    y: torch.Tensor  # [N+1] int64 or [N+1, C] float32
    train_mask: torch.Tensor  # [N+1] bool (row N = False)
    val_mask: torch.Tensor
    test_mask: torch.Tensor


def make_tables(data: GraphData, device, dtype: torch.dtype = torch.float32) -> DeviceTables:
    x = np.concatenate([data.x, np.zeros((1, data.x.shape[1]), data.x.dtype)])
    if data.y.ndim == 1:
        y = np.concatenate([data.y.astype(np.int64), np.zeros(1, np.int64)])
    else:
        y = np.concatenate([data.y.astype(np.float32),
                            np.zeros((1, data.y.shape[1]), np.float32)])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def m(mask):
        return t(np.concatenate([mask.astype(bool), [False]]))

    return DeviceTables(x=t(x).to(dtype), y=t(y), train_mask=m(data.train_mask),
                        val_mask=m(data.val_mask), test_mask=m(data.test_mask))
