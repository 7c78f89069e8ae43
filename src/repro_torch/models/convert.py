"""Carry weights, decode states and train states over from the JAX
reference.

The reference keeps parameters as a pytree with the layer stack along a
leading L axis (``repro.models.api.init_params``); handed over as a nested
dict of numpy arrays, ``params_from_numpy`` builds the port's module from
it, and ``ssm_state_from_numpy`` and ``kv_cache_from_numpy`` do the same
for a decode cache.  A transformer's layers are stacked per segment
(``{"segments": {"seg{i}": {"layers": ...}}}``), Griffin's per pattern
group with an unstacked tail (``{"groups": {"layers": ...}, "tail"}``),
an encoder-decoder's per stack (``{"encoder": {"layers": ...},
"decoder": {"layers": ...}}``).  A
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
from repro_torch.models.cache import KVCache
from repro_torch.models.griffin import _pattern
from repro_torch.models.transformer import segments_spec


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a)               # a copy: numpy views of JAX are read-only
    if arr.dtype.name == "bfloat16":        # numpy has no bf16 of its own
        return torch.as_tensor(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
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


def kv_cache_from_numpy(tree: dict, device=None) -> KVCache:
    """A reference transformer cache (``{"seg{i}": {"k", "v", "len"}}``,
    k and v (L, B, S, Hkv, D), a scalar ``len`` shared by the segments) as
    the port's ``KVCache`` on ``device``; bf16 stays bf16."""
    dev = resolve_device(device)
    written = int(np.asarray(tree["seg0"]["len"]))
    segs = {name: {"k": _tensor(seg["k"], dev), "v": _tensor(seg["v"], dev),
                   "len": torch.as_tensor(written, dtype=torch.int32,
                                          device=dev)}
            for name, seg in tree.items()}
    return KVCache(segs, written)


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
    """Every layer stack as deep as the config says: ``num_layers`` for
    the ssm family, each segment's count (``segments_spec``) for the
    transformer's, the pattern groups (and the tail's layers) for
    Griffin, each stack's count for an encoder-decoder."""
    if "segments" in params:
        spec = segments_spec(cfg)
        if sorted(params["segments"]) != [f"seg{i}" for i in range(len(spec))]:
            raise ValueError(f"segments {sorted(params['segments'])} for a "
                             f"config of {len(spec)}")
        stacks = {f"seg{i}": (params["segments"][f"seg{i}"]["layers"], n)
                  for i, (_, n) in enumerate(spec)}
    elif "groups" in params:
        _, n_groups, tail = _pattern(cfg)
        got_tail = sorted(params.get("tail", {}))
        if got_tail != [f"b{j}" for j in range(len(tail))]:
            raise ValueError(f"tail {got_tail} for a config whose tail is "
                             f"{list(tail)}")
        stacks = {"groups": (params["groups"]["layers"], n_groups)}
    elif "encoder" in params:
        stacks = {part: (params[part]["layers"], n) for part, n in (
            ("encoder", cfg.num_encoder_layers),
            ("decoder", cfg.num_decoder_layers))}
    else:
        stacks = {"layers": (params["layers"], cfg.num_layers)}
    for name, (layers, n) in stacks.items():
        depth = {int(v.shape[0]) for v in _leaves(layers)}
        if depth != {n}:
            raise ValueError(f"{name}: layer stacks of depth {sorted(depth)} "
                             f"for a {n}-layer config")


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t
