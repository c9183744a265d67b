"""Evaluation metrics and mask helpers (reference: utils.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def index2mask(idx: np.ndarray, size: int) -> np.ndarray:
    """Boolean mask from an index array (reference: utils.py:9-12)."""
    mask = np.zeros(size, dtype=bool)
    mask[np.asarray(idx)] = True
    return mask


def compute_micro_f1(
    logits: np.ndarray, y: np.ndarray, mask: Optional[np.ndarray] = None
) -> float:
    """Accuracy for single-label targets, micro-F1 for multi-label targets
    (reference: utils.py:15-35)."""
    logits = np.asarray(logits)
    y = np.asarray(y)
    if mask is not None:
        logits, y = logits[np.asarray(mask)], y[np.asarray(mask)]
    if y.ndim == 1:
        if y.size == 0:
            return 0.0
        return float((logits.argmax(axis=-1) == y).sum() / y.shape[0])
    y_pred = logits > 0
    y_true = y > 0.5
    tp = int((y_true & y_pred).sum())
    fp = int((~y_true & y_pred).sum())
    fn = int((y_true & ~y_pred).sum())
    if tp + fp == 0 or tp + fn == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def split_metrics_device(out_table: torch.Tensor, y: torch.Tensor,
                         train_mask: torch.Tensor, val_mask: torch.Tensor,
                         test_mask: torch.Tensor):
    """The three split accuracies computed on the device from the
    ``[N+1, C]`` logits table (same semantics as :func:`compute_micro_f1`);
    only three scalars come back to the host.  The trailing pad row is
    excluded by the masks (False there by construction)."""
    counts = split_counts(out_table, y, (train_mask, val_mask, test_mask))
    return split_metrics_from_counts(counts, y.ndim > 1)


def split_counts(out_table: torch.Tensor, y: torch.Tensor, masks) -> torch.Tensor:
    """``[splits, 3]`` int64 counts of rows of a logits table: per split,
    (hits, rows, rows) single-label or (tp, fp, fn) multi-label.  Counts
    of disjoint row sets add up, so a row-sharded table's slabs are summed
    over the ranks before :func:`split_metrics_from_counts`."""
    rows = []
    for mask in masks:
        if y.ndim == 1:
            hit = (out_table.argmax(dim=-1) == y) & mask
            rows.append(torch.stack([hit.sum(), mask.sum(), mask.sum()]))
            continue
        y_pred = (out_table > 0) & mask[:, None]
        y_true = (y > 0.5) & mask[:, None]
        rows.append(torch.stack([(y_true & y_pred).sum(), (~y_true & y_pred).sum(),
                                 (y_true & ~y_pred).sum()]))
    return torch.stack(rows)


def split_metrics_from_counts(counts: torch.Tensor, multilabel: bool):
    """Each split's accuracy (micro-F1 when ``multilabel``) from
    :func:`split_counts`."""

    def one(c):
        if not multilabel:
            return c[0] / c[1].clamp(min=1)
        tp, fp, fn = c[0], c[1], c[2]
        precision = tp / (tp + fp).clamp(min=1)
        recall = tp / (tp + fn).clamp(min=1)
        f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-30)
        return torch.where(precision + recall > 0, f1, torch.zeros_like(f1))

    return tuple(float(one(c)) for c in counts)


def gen_masks(
    y: np.ndarray,
    train_per_class: int = 20,
    val_per_class: int = 30,
    num_splits: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random per-class train/val splits, ``[N, num_splits]`` each
    (reference: utils.py:38-59); the rest of each split is test."""
    rng = np.random.default_rng(seed)
    num_classes = int(y.max()) + 1
    n = y.shape[0]
    train_mask = np.zeros((n, num_splits), dtype=bool)
    val_mask = np.zeros((n, num_splits), dtype=bool)
    for c in range(num_classes):
        idx = np.nonzero(y == c)[0]
        for s in range(num_splits):
            perm = rng.permutation(idx.shape[0])
            pidx = idx[perm]
            train_mask[pidx[:train_per_class], s] = True
            val_mask[pidx[train_per_class : train_per_class + val_per_class], s] = True
    test_mask = ~(train_mask | val_mask)
    return train_mask, val_mask, test_mask
