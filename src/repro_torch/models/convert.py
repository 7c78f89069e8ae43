"""Carry weights and decode states over from the JAX reference.

The reference keeps parameters as a pytree with the layer stack along a
leading L axis (``repro.models.api.init_params``); handed over as a nested
dict of numpy arrays, ``params_from_numpy`` builds the port's module from
it, and ``ssm_state_from_numpy`` does the same for a decode cache.  Values
are copied as they are: the same weights give the same model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a)               # a copy: numpy views of JAX are read-only
    return torch.as_tensor(arr).to(device)


def _tree(t, device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    return _tensor(t, device)


def params_from_numpy(tree: dict, cfg, device=None):
    """The reference's parameter pytree (numpy arrays, layers stacked on a
    leading L axis) as the port's model on ``device`` (the card unless
    named)."""
    mod = api.module_for(cfg)
    dev = resolve_device(device)
    stacked = _tree(tree["layers"], dev)
    depth = {int(v.shape[0]) for v in _leaves(stacked)}
    if depth != {cfg.num_layers}:
        raise ValueError(f"layer stacks of depth {sorted(depth)} for a "
                         f"{cfg.num_layers}-layer config")
    layers = [_index(stacked, i) for i in range(cfg.num_layers)]
    top = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    return mod.Mamba2LM(cfg, {**top, "layers": layers})


def ssm_state_from_numpy(tree: dict, device=None) -> dict:
    """A reference SSM decode state (``h`` (L, B, H, P, N), ``conv``
    (L, B, K-1, C), scalar ``len``) as the port's cache on ``device``."""
    dev = resolve_device(device)
    return {"h": _tensor(tree["h"], dev), "conv": _tensor(tree["conv"], dev),
            "len": torch.as_tensor(int(np.asarray(tree["len"])),
                                   dtype=torch.int32, device=dev)}


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


def _index(t, i):
    if isinstance(t, dict):
        return {k: _index(v, i) for k, v in t.items()}
    return t[i].clone()
