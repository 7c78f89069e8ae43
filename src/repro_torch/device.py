"""Where the port's entry points run, and how inputs become tensors there.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"`` (the tests do).  With no CUDA device and no explicit
request they raise: nothing quietly carries on on the CPU.

A ``Mesh`` lays torch devices out on named axes, as a
``jax.sharding.Mesh`` does for the reference's ``shard_map``: one process
drives every device of it (core/distributed.py).  Its device list may
name one card several times (logical shards), so every sharded path runs
on a machine with one card, and spans more cards with no change.

Inputs follow the reference's dtype rules.  JAX runs without x64, so it
computes on float32 and int32 even when handed float64 or int64 numpy
arrays; ``as_tensor`` casts the same way, or float64 frames would bin
on other boundaries (``floor(float32(x) * b)`` vs ``floor(x * b)``).
"""

from __future__ import annotations

import numpy as np
import torch

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain torch versions")
        return torch.device("cuda")
    return torch.device(device)


class Mesh:
    """Torch devices on named axes: ``devices`` is an ndarray of
    ``torch.device`` with one dimension per name in ``axis_names``.
    ``shape`` maps each name to its size, so ``dict(mesh.shape)[axis]``
    reads as it does for a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.ravel()]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-d device array for axes "
                f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def grid(self, axes) -> np.ndarray:
        """The devices along ``axes``, in that order, at index 0 of every
        other axis: where each shard of a mapping over ``axes`` computes.
        The other axes replicate it, and the port computes it once."""
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"mesh axes {self.axis_names} lack {missing}")
        sub = self.devices[tuple(slice(None) if a in axes else 0
                                 for a in self.axis_names)]
        kept = [a for a in self.axis_names if a in axes]
        return np.transpose(sub, [kept.index(a) for a in axes])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.ravel()]})")


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` (numpy array, tensor or nested list) as a tensor on
    ``resolve_device(device)``, 64-bit types narrowed to 32 bits."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.asarray(x)
        if not arr.flags.writeable:     # e.g. numpy views of JAX arrays
            arr = arr.copy()
        t = torch.as_tensor(arr)
    t = t.to(_NARROW.get(t.dtype, t.dtype))
    return t.to(dev)


def dtype_name(x) -> str:
    """numpy-style dtype name of an array or tensor ("uint8", ...)."""
    dt = getattr(x, "dtype", "uint8")
    return str(dt).removeprefix("torch.")
