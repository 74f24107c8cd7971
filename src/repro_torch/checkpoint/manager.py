"""Atomic, keep-k, async checkpoints of nested dicts of tensors.

The counterpart of ``repro.checkpoint.manager``, in its layout, so that
either package restores a subtree the other wrote:

* **Atomic**: a checkpoint is written to ``step_N.tmp`` and renamed to
  ``step_N`` only when complete, so a preemption mid-save never corrupts
  the restore point; ``latest()`` sees complete directories only.
* **Async**: ``save()`` copies the tree to host memory at once and writes
  it in one background thread, overlapping the next steps; ``wait()``
  joins it (every save and restore waits for the one before).
* **Keep-k**: older checkpoints are removed after a successful save,
  never before.

* **Per process**: each rank of a fleet writes its own shard as
  ``proc_{rank}.npz`` into the same ``step_N.tmp``, and marks it done; the
  rank that finds every shard done renames the directory (``processes``
  ranks in all), and the others wait for the rename, so that a finished
  ``save`` (``wait()``) means a complete checkpoint on every rank.  The
  manifest records the mesh the shards were cut for (``mesh``, its axis
  sizes); a restore on another mesh raises, naming both.

Format: ``step_{N:08d}/proc_{i}.npz`` (one array per leaf, keyed by its
``/``-joined path, e.g. ``params/blocks/attn/wq``) and ``manifest.json``
with the step and the keys (and the mesh, where there is one).  numpy has
no bfloat16, so a bfloat16 leaf is stored as float32 (exact) and cast
back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

SHARD_WAIT_S = 600     # how long a rank waits for the others' shards


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _paths(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _paths(tree[k], f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in _paths(tree)}


class CheckpointManager:
    """``mesh``: the axis sizes the shards are cut for (``{"data": 2,
    "model": 2}``; None on one card); ``processes``: the ranks that each
    write a shard of every checkpoint."""

    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0, mesh: dict | None = None,
                 processes: int = 1):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
        self.mesh = dict(mesh) if mesh is not None else None
        self.processes = processes
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: dict, blocking: bool = False) -> None:
        self.wait()
        host = _flatten(tree)          # device->host copy happens here
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"proc_{self.process_index}.npz"), **flat)
        if self.processes > 1:
            open(os.path.join(tmp, f"done_{self.process_index}"), "w").close()
            done = all(os.path.exists(os.path.join(tmp, f"done_{i}"))
                       for i in range(self.processes))
            if not (done and self._claim(tmp)):
                self._await(final)
                return
            for i in range(self.processes):
                os.unlink(os.path.join(tmp, f"done_{i}"))
            os.rmdir(os.path.join(tmp, "claim"))
        manifest = {"step": step, "keys": sorted(flat)}
        if self.mesh is not None:
            manifest["mesh"] = self.mesh
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, final)
        self._gc()

    @staticmethod
    def _claim(tmp: str) -> bool:
        """True for exactly one of the ranks that found every shard done."""
        try:
            os.mkdir(os.path.join(tmp, "claim"))
            return True
        except FileExistsError:
            return False

    def _await(self, final: str) -> None:
        deadline = time.monotonic() + SHARD_WAIT_S
        while not os.path.exists(final):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{final}: not every one of {self.processes} ranks "
                    f"wrote its shard within {SHARD_WAIT_S} s")
            time.sleep(0.05)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: dict, step: int | None = None):
        """A tree of ``tree_like``'s structure with the values of checkpoint
        ``step`` (the latest when None; None when there is none).  Each
        tensor leaf comes back on its device and in its dtype; keys the
        checkpoint holds beyond ``tree_like``'s are ignored."""
        self.wait()
        step = self.latest() if step is None else step
        if step is None:
            return None
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "manifest.json")) as f:
            saved = json.load(f).get("mesh")
        if saved != self.mesh:
            raise ValueError(f"checkpoint {step} holds shards for the mesh "
                             f"{saved}, but this run's mesh is {self.mesh}")
        path = os.path.join(self.dir, f"step_{step:08d}",
                            f"proc_{self.process_index}.npz")
        with np.load(path) as data:
            missing = [k for k, _ in _paths(tree_like)
                       if k not in data.files]
            if missing:
                raise KeyError(f"checkpoint {step} missing keys: "
                               f"{missing[:5]}")

            def build(t, prefix):
                if isinstance(t, dict):
                    return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                            for k, v in t.items()}
                arr = data[prefix]
                if isinstance(t, torch.Tensor):
                    if tuple(arr.shape) != tuple(t.shape):
                        raise ValueError(f"checkpoint {step}: {prefix} has "
                                         f"shape {arr.shape}, expected "
                                         f"{tuple(t.shape)}")
                    return torch.from_numpy(arr).to(device=t.device,
                                                    dtype=t.dtype)
                return arr
            return build(tree_like, "")
