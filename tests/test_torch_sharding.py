"""The port's sharding specs (``repro_torch.sharding.rules``,
``train_step.state_shardings`` / ``batch_shardings``) against the
reference's, leaf for leaf, for all ten configs at their published sizes.

The reference runs in this process on a device-free
``jax.sharding.AbstractMesh`` over shapes from ``jax.eval_shape``; the
port on a ``device.Mesh`` of CPU entries over shapes from its own
``train_step.eval_shape`` (fake tensors: no memory).  Specs are equal
exactly: there is no tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.models import api as ref_api
from repro.sharding.rules import ShardingRules as RefRules
from repro.sharding.rules import cache_shardings as ref_cache_shardings
from repro.sharding.rules import param_shardings as ref_param_shardings
from repro.train import batch_shardings as ref_batch_shardings
from repro.train import init_state as ref_init_state
from repro.train import make_optimizer as ref_make_optimizer
from repro.train import state_shardings as ref_state_shardings
from repro_torch.configs import get_config
from repro_torch.device import Mesh
from repro_torch.models import api
from repro_torch.sharding import (
    NamedSharding, PartitionSpec, ShardingRules, cache_shardings, constrain,
    current_context, param_shardings, sharding_context,
)
from repro_torch.train import (
    batch_shardings, init_state, make_optimizer, state_shardings,
)
from repro_torch.train.train_step import eval_shape

MESHES = {
    "data2-model4": ((2, 4), ("data", "model")),
    "data16-model16": ((16, 16), ("data", "model")),
    "pod2-data16-model16": ((2, 16, 16), ("pod", "data", "model")),
}


def meshes(name):
    """The reference's abstract mesh and the port's mesh of CPU entries."""
    shape, axes = MESHES[name]
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = ["cpu"] * devices.size
    return AbstractMesh(shape, axes), Mesh(devices.reshape(shape), axes)


def specs(tree, prefix=""):
    """Every leaf's spec as a tuple, by path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(specs(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.spec)}


def assert_specs_equal(got, want):
    got, want = specs(got), specs(want)
    assert sorted(got) == sorted(want)
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diff, diff


def both_configs(arch, **kw):
    return (dataclasses.replace(ref_get_config(arch), **kw),
            dataclasses.replace(get_config(arch), **kw))


def both_states(arch, optimizer):
    """The reference's train state shape and the port's (with the error
    buffer), for ``optimizer``."""
    rcfg, cfg = both_configs(arch, optimizer=optimizer)
    ref = jax.eval_shape(lambda: ref_init_state(
        jax.random.PRNGKey(0), rcfg, ref_make_optimizer(rcfg), compress=True))
    mine = eval_shape(lambda: init_state(
        torch.Generator().manual_seed(0), cfg, make_optimizer(cfg),
        compress=True))
    return ref, mine


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_equal_reference(arch, mesh_name):
    """param_shardings and state_shardings (AdamW and Adafactor moments,
    the int8 error buffer, the step) equal the reference's leaf for leaf
    at the published config, including the head-count fallback to
    head_dim and the MoE expert and FSDP dimensions."""
    ref_mesh, mesh = meshes(mesh_name)
    for optimizer in ("adamw", "adafactor"):
        ref_state, state = both_states(arch, optimizer)
        got = state_shardings(state, mesh, ShardingRules())
        want = ref_state_shardings(ref_state, ref_mesh, RefRules())
        assert_specs_equal(got, want)
        assert_specs_equal(param_shardings(state["params"], mesh),
                           ref_param_shardings(ref_state["params"], ref_mesh))
        assert all(s.mesh is mesh for s in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, NamedSharding)))
    # the published widths reach every kind of spec somewhere
    flat = specs(got)
    assert any(any(e is not None for e in s) for s in flat.values())


@pytest.mark.parametrize("layout", ["heads", "seq"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh_name, layout):
    """cache_shardings of a decode cache (batch 32, 4096 positions) equals
    the reference's under both decode-cache layouts."""
    ref_mesh, mesh = meshes(mesh_name)
    rcfg, cfg = both_configs(arch)
    ref_cache = jax.eval_shape(lambda: ref_api.init_cache(rcfg, 32, 4096))
    cache = eval_shape(lambda: api.init_cache(cfg, 32, 4096, device="cpu"))
    assert_specs_equal(
        cache_shardings(cache, mesh, ShardingRules(decode_cache_layout=layout)),
        ref_cache_shardings(ref_cache, ref_mesh,
                            RefRules(decode_cache_layout=layout)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_equal_reference(mesh_name):
    """batch_shardings: the batch dim over the DP axes where they divide
    it, replicated otherwise and for scalars."""
    ref_mesh, mesh = meshes(mesh_name)
    for b in (1, 2, 8, 32, 64):
        shapes = {"tokens": (b, 128), "labels": (b, 128),
                  "prefix_embeds": (b, 16, 64), "weight": ()}
        ref = {k: jax.ShapeDtypeStruct(v, np.float32)
               for k, v in shapes.items()}
        mine = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
        assert_specs_equal(batch_shardings(mine, mesh),
                           ref_batch_shardings(ref, ref_mesh))


def test_rules_context_and_constrain():
    """The context is thread-local and nests; constrain returns its input
    with or without one; a sharding is held on its mesh's first device."""
    _, mesh = meshes("data2-model4")
    x = torch.arange(6.0).reshape(2, 3)
    assert current_context() is None
    assert constrain(x, "batch", "tp") is x
    rules = ShardingRules(decode_cache_layout="seq")
    with sharding_context(mesh, rules):
        assert current_context().mesh is mesh
        assert current_context().rules is rules
        assert constrain(x, "batch", None) is x
        with sharding_context(mesh):
            assert current_context().rules == ShardingRules()
        assert current_context().rules is rules
    assert current_context() is None
    assert ShardingRules().present(mesh, ("pod", "data")) == ("data",)
    s = NamedSharding(mesh, PartitionSpec("data", None))
    assert s.device == torch.device("cpu")
    assert s == NamedSharding(mesh, PartitionSpec("data", None))
    assert tuple(s.spec) == ("data", None)
