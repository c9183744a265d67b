"""Checkpoint / resume (port of ``incagg_gnn_tpu/train/checkpoint.py``).

A checkpoint captures the complete training state: parameters and
BatchNorm statistics, the Adam state (its step counts on the parameters'
device), both history stacks (or the spill tier's host tables), the device
generator (also the one a fused epoch's CUDA graph draws from: replays
advance its state as steps do) and the training loader's epoch (its
shuffle is seeded by the epoch).  Restoring drops the trainer's captured
epoch graph, which holds the Adam state it replaces.  Checkpoints are written at the epoch
boundary right after the refresh, where the caches are freshly consistent,
so resume needs no mid-epoch replay.

Format (the JAX package's file contract): ``ckpt_NNNNNN.npz`` holding one
array per state entry, and a JSON sidecar ``ckpt_NNNNNN.npz.meta.json``;
both are written under private names and renamed into place.  A state entry
whose dtype numpy lacks (bfloat16, float8) is stored as float32, which
holds it exactly, and cast back on load.

:class:`CheckpointManager` also restores the JAX package's checkpoints of
the single-device trainer, whose sidecar holds the pytree's ``treedef``
(``convert.state_from_jax_checkpoint`` maps their leaves onto the port's state).
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch

#: the sidecar's ``format`` of the port's own checkpoints
FORMAT = "incagg_gnn_tpu_torch"


class CheckpointMismatch(ValueError):
    """A checkpoint whose entries or shapes differ from the trainer's: a
    different architecture or config, not a corrupt file."""


def _to_savable(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def save_state(path: str, state: Mapping[str, object],
               meta: Optional[dict] = None) -> None:
    """Write ``state`` (name -> tensor or array) to ``path`` and its meta
    sidecar, each atomically."""
    arrays = {k: _to_savable(v) for k, v in state.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez adds no suffix
        np.savez(f, **arrays)
    os.replace(tmp, path)
    # the sidecar's write is atomic too: the supervisor's progress check and
    # maybe_restore read the newest one, possibly right after a crash
    mtmp = path + ".meta.json.tmp"
    with open(mtmp, "w") as f:
        json.dump({"format": FORMAT, "num_entries": len(arrays),
                   **(meta or {})}, f)
    os.replace(mtmp, path + ".meta.json")


def read_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


def load_state(path: str, like: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The arrays of ``path`` as tensors of ``like``'s dtypes and devices.
    Raises :class:`CheckpointMismatch` when the names or shapes differ from
    ``like``'s."""
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    return conform(got, like)


def conform(got: Mapping[str, np.ndarray],
            like: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """``got``'s arrays as tensors shaped, typed and placed like ``like``'s."""
    if set(got) != set(like):
        missing = sorted(set(like) - set(got))[:4]
        extra = sorted(set(got) - set(like))[:4]
        raise CheckpointMismatch(
            f"checkpoint entries differ from the trainer's (missing {missing}, "
            f"unexpected {extra}) — was the checkpoint saved with a different "
            f"architecture/config?")
    out = {}
    for k, ref in like.items():
        a = np.asarray(got[k])
        ref_t = ref if isinstance(ref, torch.Tensor) else torch.as_tensor(ref)
        if a.shape != tuple(ref_t.shape):
            raise CheckpointMismatch(
                f"checkpoint entry {k} has shape {a.shape} but the trainer "
                f"expects {tuple(ref_t.shape)} — was the checkpoint saved with "
                f"a different architecture/config?")
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(
            device=ref_t.device, dtype=ref_t.dtype)
    return out


def _ckpt_names(directory: str):
    return sorted(f for f in os.listdir(directory)
                  if f.startswith("ckpt_") and f.endswith(".npz")
                  and ".hist-" not in f)


class CheckpointManager:
    """Saves and restores a trainer's full state under a directory.

    Works with every trainer through the two-method protocol
    ``checkpoint_state() -> {name: tensor}`` / ``restore_checkpoint(state)``:
    the single-device :class:`~incagg_gnn_tpu_torch.train.trainer.Trainer`
    and the host-spill
    :class:`~incagg_gnn_tpu_torch.train.spill_trainer.SpillVRTrainer`
    (whose host tables are saved and restored in place)."""

    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, trainer, epoch: int, extra: Optional[dict] = None):
        """``extra``: JSON-serializable scalars stored in the sidecar (the
        best val/test so far, so a supervised restart reports the finals
        of the whole run)."""
        path = os.path.join(self.dir, f"ckpt_{epoch:06d}.npz")
        save_state(path, trainer.checkpoint_state(),
                   meta={"epoch": epoch, **(extra or {})})
        self._gc()

    def latest(self) -> Optional[str]:
        cks = _ckpt_names(self.dir)
        return os.path.join(self.dir, cks[-1]) if cks else None

    def maybe_restore(self, trainer) -> bool:
        """Restore the newest readable checkpoint (the port's or the JAX
        package's).

        A corrupt file (truncated write, partial copy) is skipped with a
        warning and the next newest is tried — the ``keep`` > 1 retention
        exists for this.  A name or shape mismatch is a config mismatch,
        which older checkpoints share: that ``ValueError`` propagates."""
        for name in reversed(_ckpt_names(self.dir)):
            path = os.path.join(self.dir, name)
            try:
                meta = read_meta(path)
                epoch = meta["epoch"]
                like = trainer.checkpoint_state()
                if "treedef" in meta:  # written by the JAX package
                    from incagg_gnn_tpu_torch.convert import state_from_jax_checkpoint

                    with np.load(path) as z:
                        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
                    restored = conform(
                        state_from_jax_checkpoint(trainer, leaves, meta["treedef"],
                                             epoch), like)
                else:
                    restored = load_state(path, like)
            except CheckpointMismatch:
                raise  # older checkpoints would mismatch the same way
            except Exception as e:  # truncated zip, missing meta, bad keys
                warnings.warn(f"skipping unreadable checkpoint {path}: "
                              f"{type(e).__name__}: {e}")
                continue
            trainer.restore_checkpoint(restored)
            trainer.epoch = epoch + 1
            trainer.restored_meta = meta  # extra scalars (e.g. best acc)
            return True
        return False

    def _gc(self):
        names = os.listdir(self.dir)
        stems = sorted({m.group(1) for f in names
                        if (m := re.match(r"(ckpt_\d+)\.", f))})
        for stem in stems[: -self.keep]:
            for f in names:
                if f.startswith(stem + "."):
                    try:
                        os.remove(os.path.join(self.dir, f))
                    except FileNotFoundError:
                        pass  # another process's _gc won the race
