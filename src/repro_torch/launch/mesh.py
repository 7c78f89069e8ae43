"""Meshes over the visible cards (tests and one host).

Port of ``repro/launch/mesh.py``'s ``make_host_mesh``: what
``launch/train.py --mesh host`` trains over, and what the sharded paths
of the models (``sharding/rules.py``) and of §4.6 (``core/distributed.py``)
split their work over.  The reference's ``make_production_mesh`` (16x16
TPU v5e pods) feeds ``launch/dryrun.py`` and comes with it (ROADMAP 1.9d).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import Mesh


def make_host_mesh(shape=None, axes=("data", "model"), devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``devices``, by default every visible
    card; ``shape=None`` is ``(1, len(devices))``.  ``devices`` may name
    one device several times (``["cpu"] * 4``, ``["cuda:0"] * 4``): each
    entry is a shard of its own.  With no card and no ``devices`` it
    raises, as ``device.resolve_device`` does."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: make_host_mesh spans the visible cards; "
                "pass devices=['cpu'] * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if shape is None:
        shape = (1, len(devices))
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {int(np.prod(shape))} "
            f"devices, got {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(tuple(shape)), axes)
