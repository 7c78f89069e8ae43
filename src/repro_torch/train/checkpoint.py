"""Fault-tolerant checkpointing: atomic, device-agnostic, the reference's
layout.

Port of ``repro/train/checkpoint.py``, on disk the same:

  <dir>/step_00000123/
      manifest.json      tree structure, shapes, dtypes, step
      <flat-key>.npy     one file per leaf (path '/'-joined, '__' in names)
  <dir>/latest           text file naming the newest complete step

so a checkpoint either package writes restores in the other's tree (a
train state of both is the same nested dict, train/train_step.py).

Guarantees:
  * atomic: written to step_X.tmp-<pid>, fsync'd, then os.rename; a crash
    mid-save never corrupts ``latest``;
  * device-agnostic: leaves are stored as host arrays and restored onto
    the device the caller names, or where a tree of shardings
    (``train_step.state_shardings``) places them: a sharded state is held
    whole on its mesh's first device;
  * async: ``save_async`` copies every leaf to the host before it returns
    (the device-to-host copies, one synchronize), then writes on a thread,
    so the training loop may update the state in place at once;
  * bounded: ``keep_last`` prunes old steps after each successful save.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save --
    def save(self, state, step: int):
        self.wait()
        host = {k: _host(v) for k, v in _flatten(state).items()}
        self._write(host, step)

    def save_async(self, state, step: int):
        """Device->host copies happen now; disk I/O on a writer thread."""
        self.wait()
        host = {k: _host(v) for k, v in _flatten(state).items()}
        self._thread = threading.Thread(
            target=self._write, args=(host, step), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host: dict, step: int):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host.items():
            fname = key.replace(_SEP, "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, f".latest-{os.getpid()}")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.rename(latest_tmp, os.path.join(self.dir, "latest"))
        self._prune()

    def _prune(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and ".tmp" not in d)
        for d in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> int | None:
        latest = os.path.join(self.dir, "latest")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            return None
        return int(name.split("_")[1])

    def restore(self, step: int | None = None, device=None,
                shardings=None):
        """Load a checkpoint as a tree of tensors; None when there is none.

        ``shardings``: an optional tree of ``NamedSharding`` in the
        state's structure; a leaf it names goes to its sharding's device
        (the mesh's first), every other leaf to ``device`` (the card
        unless named)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        flat_sh = {} if shardings is None else _flatten(shardings)
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for key, meta in manifest["leaves"].items():
            dev = (flat_sh[key].device if key in flat_sh
                   else resolve_device(device))
            flat[key] = torch.as_tensor(
                np.load(os.path.join(path, meta["file"]))).to(dev)
        return _unflatten(flat)
