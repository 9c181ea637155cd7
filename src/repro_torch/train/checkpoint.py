"""Fault-tolerant checkpointing: atomic writes, keep-k, async, resume.

The JAX reference's ``train/checkpoint.py``, over the port's trees:

  * atomic: each checkpoint is written to ``<dir>/tmp.<step>`` and moved to
    ``<dir>/ckpt_<step:010d>`` by ``os.replace``, so a crashed writer never
    corrupts the newest checkpoint;
  * keep-k: the newest ``keep`` complete checkpoints stay; older ones,
    incomplete ``ckpt_*`` directories and stale ``tmp.*`` directories go;
  * async: the device-to-host copy happens in ``save`` (the caller may
    change its state at once), the disk write on a NON-daemon thread, so
    an in-flight write completes even when the main thread dies with an
    exception;
  * one format for both packages: ``state.npz`` keyed by the reference's
    tree paths (``jax.tree_util.keystr``: ``['params']['layers']['wq']``,
    ``['params']['mlp'][0]['w']``), bf16 leaves written as f32 and cast
    back on restore, and ``meta.json``. A checkpoint written by either
    package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..core.common import tensor_from_host
from .._tree import tree_leaves, tree_map


def keystr(path: tuple) -> str:
    """The reference's key of a tree path (``jax.tree_util.keystr``):
    ``[repr(key)]`` for a dict key, ``[i]`` for a list position."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def _host(leaf: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU: the caller may change its state at once
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:         # npz can't round-trip bf16
        t = t.to(torch.float32)
    return t.numpy()


def _flatten(tree) -> dict:
    return {keystr(path): _host(leaf) for path, leaf in tree_leaves(tree)}


def _unflatten(tree_like, data: dict):
    """``data``'s arrays in the structure of ``tree_like``, each cast to
    its leaf's dtype and placed on its leaf's device."""
    paths = iter([path for path, _ in tree_leaves(tree_like)])
    return tree_map(lambda like: tensor_from_host(
        data[keystr(next(paths))], "cpu").to(dtype=like.dtype,
                                              device=like.device), tree_like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._lock = threading.Lock()
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state, extra: dict | None = None) -> None:
        host = _flatten(state)           # device -> host now
        meta = {"step": int(step), **(extra or {})}
        if self.async_write:
            self.wait()
            # non-daemon: a crash between save() and the end of the write
            # must not kill the writer, or resume would fall back to the
            # previous checkpoint
            t = threading.Thread(target=self._write, args=(step, host, meta),
                                 daemon=False)
            t.start()
            self._pending = t
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict) -> None:
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"ckpt_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "state.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        if not self.keep:
            return
        # keep the newest ``keep`` COMPLETE checkpoints; older ones and
        # incomplete ``ckpt_*`` directories go, and so does any ``tmp.*``
        # (the write in flight was moved before this runs, and save()
        # serialises writers, so a ``tmp.*`` is a dead process's)
        keep_names = {f"ckpt_{s:010d}" for s in self.all_steps()[-self.keep:]}
        for name in os.listdir(self.dir):
            if (name.startswith("ckpt_") and name not in keep_names) \
                    or name.startswith("tmp."):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- read -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Steps of the COMPLETE checkpoints (both payload files present),
        ascending."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and all(
                    os.path.exists(os.path.join(self.dir, name, f))
                    for f in ("state.npz", "meta.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure, dtypes and devices of
        ``state_like``. Returns ``(state, meta)``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"ckpt_{step:010d}")
        with np.load(os.path.join(path, "state.npz")) as npz:
            data = dict(npz)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten(state_like, data), meta
