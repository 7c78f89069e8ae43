"""Carry weights, decode states and train states over from the JAX
reference.

The reference keeps parameters as a pytree with the layer stack along a
leading L axis (``repro.models.api.init_params``); handed over as a nested
dict of numpy arrays, ``params_from_numpy`` builds the port's module from
it, and ``ssm_state_from_numpy`` does the same for a decode cache.  A
train state (``repro.train.init_state``: params, optimizer moments, step,
error buffer) keeps that layout in the port too, so
``train_state_from_numpy`` carries it over leaf for leaf.  Values are
copied as they are: the same weights give the same model.
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
    params = _tree(tree, resolve_device(device))
    _check_depth(params, cfg)
    return api.model_over(params, cfg)


def ssm_state_from_numpy(tree: dict, device=None) -> dict:
    """A reference SSM decode state (``h`` (L, B, H, P, N), ``conv``
    (L, B, K-1, C), scalar ``len``) as the port's cache on ``device``."""
    dev = resolve_device(device)
    return {"h": _tensor(tree["h"], dev), "conv": _tensor(tree["conv"], dev),
            "len": torch.as_tensor(int(np.asarray(tree["len"])),
                                   dtype=torch.int32, device=dev)}


def train_state_from_numpy(tree: dict, cfg, device=None) -> dict:
    """A reference train state (numpy arrays: "params" in the reference's
    layout, "opt" with AdamW's "mu"/"nu" or Adafactor's per-leaf
    "vr"/"vc"/"v", a scalar "step", an optional error buffer "err") as the
    port's train state on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    state = {k: _tree(tree[k], dev) for k in ("params", "opt")}
    _check_depth(state["params"], cfg)
    state["step"] = torch.as_tensor(int(np.asarray(tree["step"])),
                                    dtype=torch.int32, device=dev)
    if "err" in tree:
        state["err"] = _tree(tree["err"], dev)
    return state


def _check_depth(params: dict, cfg) -> None:
    depth = {int(v.shape[0]) for v in _leaves(params["layers"])}
    if depth != {cfg.num_layers}:
        raise ValueError(f"layer stacks of depth {sorted(depth)} for a "
                         f"{cfg.num_layers}-layer config")


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t
