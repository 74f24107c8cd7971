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

Format: ``step_{N:08d}/proc_{i}.npz`` (one array per leaf, keyed by its
``/``-joined path, e.g. ``params/blocks/attn/wq``) and ``manifest.json``
with the step and the keys.  numpy has no bfloat16, so a bfloat16 leaf is
stored as float32 (exact) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


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
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
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
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(tmp, ignore_errors=True)
        else:
            os.replace(tmp, final)
        self._gc()

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
