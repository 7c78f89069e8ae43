"""Where the port's entry points run, and how inputs become tensors there.

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"`` (the tests do).  With no CUDA device and no explicit
request they raise: nothing quietly carries on on the CPU.

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
