"""Meshes over the visible cards (tests and one host).

Port of ``repro/launch/mesh.py``.  ``make_host_mesh`` is what
``launch/train.py --mesh host`` trains over, and what the sharded paths
of the models (``sharding/rules.py``) and of §4.6 (``core/distributed.py``)
split their work over.  ``make_production_mesh`` has the reference's
production shapes and axes, (16, 16) ``("data", "model")`` for one pod of
256 cards and (2, 16, 16) ``("pod", "data", "model")`` for two: what
``launch/train.py --mesh pod|multipod`` asks for, and, over
``["meta"] * 256`` (or 512), what ``launch/dryrun.py`` counts a step on.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import Mesh


def _visible_cards() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_host_mesh(shape=None, axes=("data", "model"), devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``devices``, by default every visible
    card; ``shape=None`` is ``(1, len(devices))``.  ``devices`` may name
    one device several times (``["cpu"] * 4``, ``["cuda:0"] * 4``): each
    entry is a shard of its own.  With no card and no ``devices`` it
    raises, as ``device.resolve_device`` does."""
    if devices is None:
        devices = _visible_cards()
        if not devices:
            raise RuntimeError(
                "no CUDA device: make_host_mesh spans the visible cards; "
                "pass devices=['cpu'] * n to build a mesh on the CPU")
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


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) on ``("data", "model")``,
    or (2, 16, 16) on ``("pod", "data", "model")`` with ``multi_pod``.

    With no ``devices`` it spans the visible cards and raises
    ``ValueError`` when fewer than the 256 (512) it needs are visible;
    ``devices=["meta"] * 256`` is what the dry run builds."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if devices is None:
        devices = _visible_cards()
        if len(devices) < need:
            raise ValueError(
                f"the {'multi-pod' if multi_pod else 'single-pod'} production "
                f"mesh {shape} needs {need} cards, {len(devices)} visible; "
                f"pass devices=['meta'] * {need} to count a step on it "
                "(launch/dryrun.py)")
        devices = devices[:need]
    return make_host_mesh(shape, axes, devices=devices)
