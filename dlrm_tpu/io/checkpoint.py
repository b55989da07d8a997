"""Sharded checkpoint / resume (orbax-backed).

The reference has NO checkpoint writer — it can only *load* PyTorch-exported
HDF5 models (/root/reference/src/data/criteo.jl:464-534) and persists just
preprocessing artifacts (criteo.jl:196-199).  SURVEY.md §5 calls for real
checkpointing: sharded table shards written in parallel,
resume with arbitrary re-sharding on restore.

Design:

* **TrainCheckpoint** = {"params": pytree, "step": int} saved via orbax
  (tensorstore under the hood: each device writes its own table shards, so a
  (N, local_rows, D) sharded embedding stack checkpoints at full aggregate
  disk bandwidth without gathering to one host).
* **Restore with re-sharding**: pass ``shardings`` (a pytree of
  ``jax.sharding.Sharding``) and the arrays come back placed for a possibly
  *different* mesh than they were saved from — resume on 8 chips from a
  4-chip run.
* **CheckpointManager** keeps ``max_to_keep`` checkpoints and knows the
  latest step, the standard production loop shape.

For cross-framework interop (PyTorch), use io/hdf5.save_params/load_params
instead — that is the fixture format; this is the fast training format.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

try:
    import orbax.checkpoint as ocp
except ImportError:  # pragma: no cover
    ocp = None


def _require_ocp():
    if ocp is None:
        raise SystemExit(
            "checkpointing needs the 'orbax-checkpoint' package (import "
            "orbax.checkpoint failed); install it, or run without "
            "--ckpt-dir")


def _abstract_from_metadata(tree: Any) -> Any:
    """Checkpoint metadata tree -> pytree of ShapeDtypeStructs (no
    shardings).  Restoring against this works on ANY topology — orbax's
    default template-less restore replays the save-time shardings and
    fails when the current devices differ (e.g. evaluating an 8-chip
    training checkpoint on one chip)."""
    return jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(tuple(m.shape), np.dtype(m.dtype)),
        tree)


def _as_state(params: Any, step: int) -> dict:
    return {"params": params, "step": int(step)}


def save_checkpoint(ckpt_dir: str, step: int, params: Any) -> str:
    """Write one checkpoint at ``ckpt_dir/<step>``; returns its path.

    ``params`` may be any pytree of (possibly sharded) jax or numpy arrays.
    """
    _require_ocp()
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, _as_state(params, step))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest integer-named subdirectory holding a complete checkpoint."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def checkpoint_metadata(ckpt_dir: str, *, step: Optional[int] = None):
    """Abstract (ShapeDtypeStruct) pytree of a checkpoint's payload —
    lets callers build per-leaf shardings BEFORE restoring, so shards
    stream straight to their devices instead of materializing on one
    host (mandatory for table stacks larger than host RAM)."""
    _require_ocp()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    if os.path.isdir(os.path.join(path, "default")):
        path = os.path.join(path, "default")
    with ocp.StandardCheckpointer() as ckptr:
        md = ckptr.metadata(path).item_metadata.tree
    return _abstract_from_metadata(md)["params"]


def _abstract_template(template, shardings):
    """ShapeDtypeStruct tree from a template (+ optional shardings).
    ``shardings`` without ``template`` would be silently dropped by the
    metadata-driven branch — reject it loudly."""
    if template is None:
        if shardings is not None:
            raise ValueError(
                "shardings requires template (a metadata-driven restore "
                "would silently ignore the shardings and materialize "
                "host-replicated arrays)")
        return None
    if shardings is not None:
        return jax.tree.map(
            lambda x, s: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                              sharding=s),
            template, shardings)
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        template)


def restore_checkpoint(ckpt_dir: str, *, step: Optional[int] = None,
                       template: Any = None, shardings: Any = None):
    """Restore (params, step) from ``ckpt_dir``.

    Args:
      step: which checkpoint; default latest.
      template: pytree of arrays or ShapeDtypeStructs describing the target
        (required when ``shardings`` is given; otherwise orbax restores the
        saved structure as numpy-backed host arrays).
      shardings: optional pytree of ``jax.sharding.Sharding`` matching
        ``template['params']``-like structure — restored arrays are placed
        directly into these shardings (possibly a different mesh than the
        save-time one).
    """
    _require_ocp()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(int(step)))
    # CheckpointManager nests the state under <step>/default/; accept both
    # layouts so save_checkpoint and CheckpointManager interoperate.
    if os.path.isdir(os.path.join(path, "default")):
        path = os.path.join(path, "default")
    abstract = _abstract_template(template, shardings)
    with ocp.StandardCheckpointer() as ckptr:
        if abstract is None:
            md = ckptr.metadata(path).item_metadata.tree
            state = ckptr.restore(path, _abstract_from_metadata(md))
        else:
            state = ckptr.restore(path, _as_state(abstract, 0))
    return state["params"], int(state["step"])


class CheckpointManager:
    """Production checkpoint loop: periodic save, bounded retention, resume.

    >>> mgr = CheckpointManager(dir, save_interval=1000, max_to_keep=3)
    >>> start = mgr.restore_latest(template=params, shardings=sh) or (params, 0)
    >>> ...
    >>> mgr.maybe_save(step, params)   # saves when step % interval == 0
    """

    def __init__(self, ckpt_dir: str, *, save_interval: int = 1000,
                 max_to_keep: int = 3):
        _require_ocp()
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.save_interval = int(save_interval)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            self.ckpt_dir,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=self.max_to_keep, create=True),
        )

    def save(self, step: int, params: Any, *, force: bool = False) -> bool:
        saved = self._mgr.save(
            int(step),
            args=ocp.args.StandardSave(_as_state(params, step)),
            force=force)
        return bool(saved)

    def maybe_save(self, step: int, params: Any) -> bool:
        if self.save_interval and step % self.save_interval == 0:
            return self.save(step, params)
        return False

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore_latest(self, *, template: Any = None, shardings: Any = None):
        """(params, step) of the newest checkpoint, or None if none exist."""
        step = self._mgr.latest_step()
        if step is None:
            return None
        abstract = _abstract_template(template, shardings)
        if abstract is None:
            # accept both layouts (flat save_checkpoint dirs and the
            # manager's <step>/default nesting), like restore_checkpoint;
            # restore through the resolved path too — the manager's own
            # restore assumes its nested layout
            path = os.path.join(self.ckpt_dir, str(step))
            if os.path.isdir(os.path.join(path, "default")):
                path = os.path.join(path, "default")
            with ocp.StandardCheckpointer() as ckptr:
                md = ckptr.metadata(path).item_metadata.tree
                state = ckptr.restore(path, _abstract_from_metadata(md))
        else:
            state = self._mgr.restore(
                step, args=ocp.args.StandardRestore(_as_state(abstract, 0)))
        return state["params"], int(state["step"])

    def wait_until_finished(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
