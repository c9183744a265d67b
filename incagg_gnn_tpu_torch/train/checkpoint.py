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
        # a mesh Trainer's ranks all gather the state, and rank 0 writes it
        state = trainer.checkpoint_state()
        if trainer.writes_checkpoint:
            save_state(path, state, meta={"epoch": epoch, **(extra or {})})
            self._gc()
        trainer.checkpoint_written()

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


class ShardedCheckpointManager(CheckpointManager):
    """Per-rank saves of the sharded trainer (``parallel/spatial.py``; JAX
    ``ShardedCheckpointManager``, train/checkpoint.py:165-273): no rank
    gathers the caches.

    Files of checkpoint epoch E: ``ckpt_E.hist-pXXX.npz``, rank XXX's own
    state (its slab of both caches, its generator), written by every rank;
    then, once every rank has written, ``ckpt_E.npz`` and its sidecar, the
    replicated state (parameters and BatchNorm statistics, Adam, the round
    counter), written by rank 0.  A restore takes the newest checkpoint
    that every rank can read, each rank its own rows."""

    def __init__(self, directory: str, mesh, keep: int = 2):
        super().__init__(directory, keep)
        self.mesh = mesh

    def _rank_path(self, stem: str, rank: int) -> str:
        return os.path.join(self.dir, f"{stem}.hist-p{rank:03d}.npz")

    def save(self, trainer, epoch: int, extra: Optional[dict] = None):
        from incagg_gnn_tpu_torch.parallel import mesh as M

        stem = f"ckpt_{epoch:06d}"
        path = self._rank_path(stem, self.mesh.rank)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _to_savable(v) for k, v in trainer.hist_arrays().items()})
        os.replace(tmp, path)
        M.barrier(self.mesh)  # every rank's rows are on disk before the sidecar
        if self.mesh.rank == 0:
            save_state(os.path.join(self.dir, stem + ".npz"),
                       trainer.replicated_checkpoint_state(),
                       meta={"epoch": epoch, "sharded_hist": True,
                             "n_dev": self.mesh.world, "slab": trainer.layout.slab,
                             **(extra or {})})
            self._gc()
        M.barrier(self.mesh)

    def maybe_restore(self, trainer) -> bool:
        from incagg_gnn_tpu_torch.parallel import mesh as M

        for name in reversed(_ckpt_names(self.dir)):
            path = os.path.join(self.dir, name)
            code, err = 1, None
            try:
                meta = read_meta(path)
                if (meta.get("n_dev"), meta.get("slab")) != (self.mesh.world,
                                                             trainer.layout.slab):
                    raise CheckpointMismatch(
                        f"checkpoint {path} holds {meta.get('n_dev')} slabs of "
                        f"{meta.get('slab')} rows, the run {self.mesh.world} of "
                        f"{trainer.layout.slab} — saved under another layout or config?")
                replicated = load_state(path, trainer.replicated_checkpoint_state())
                own = load_state(self._rank_path(name[:-len(".npz")], self.mesh.rank),
                                 trainer.hist_arrays())
            except CheckpointMismatch as e:
                code, err = -1, e
            except Exception as e:  # truncated zip, missing file or meta
                code, err = 0, e
            # the ranks restore one checkpoint or none
            agreed = M.all_reduce_min(self.mesh, code)
            if agreed < 0:
                raise err if code < 0 else CheckpointMismatch(
                    f"another rank found checkpoint {path} mismatched")
            if agreed == 0:
                warnings.warn(f"skipping checkpoint {path} that not every rank can read"
                              + (f": {type(err).__name__}: {err}" if err else ""))
                continue
            trainer.restore_replicated(replicated)
            trainer.set_hist_arrays(own)
            trainer.epoch = meta["epoch"] + 1
            trainer.restored_meta = meta
            return True
        return False
