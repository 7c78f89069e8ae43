"""Sharded training's plumbing on the CPU: ``launch/train.py --mesh host``
against ``--mesh none``, ``CheckpointManager.restore(shardings=)`` and
``train_step.state_shardings`` of a live state.

On a (1, 1) host mesh every sharded path computes what the unsharded one
does, in the same order, so the runs are held bit for bit (no
tolerance).  The specs themselves are held against the reference's in
tests/test_torch_sharding.py.
"""

from __future__ import annotations

import io
import tempfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import NamedSharding
from repro_torch.train import (
    CheckpointManager, init_state, make_optimizer, state_shardings,
)
from repro_torch.train.train_step import eval_shape
from repro_torch.train.tree import tree_leaves


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _train(mesh, arch, d, extra=()):
    out = io.StringIO()
    with redirect_stdout(out):
        state, history = train_launch.main([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-dir", d,
            "--ckpt-every", "2", "--mesh", mesh, *extra])
    return state, history, out.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("arch", ["mamba2-130m", "kimi-k2-1t-a32b"])
def test_mesh_host_trains_bit_equal_to_mesh_none(arch):
    """--mesh host (a (1, 1) mesh over --device, every step inside the
    sharding context; kimi's MoE takes the expert-parallel path) ends
    bit-equal to --mesh none, also through a fault and a restore from the
    sharded checkpoint."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        plain, h_plain, line_plain = _train("none", arch, d1)
        sharded, h_sharded, line = _train("host", arch, d2,
                                          ["--fail-at", "3"])
    assert line == line_plain and line.startswith("done: step=4")
    assert [h["loss"] for h in h_sharded] == [h["loss"] for h in h_plain]
    a, b = _flat(plain), _flat(sharded)
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_restore_places_each_sharded_leaf_on_its_mesh_first_device():
    """A restore with shardings puts every leaf they name on its
    sharding's device (the mesh's first: here the meta device, to see
    it) and any other leaf on ``device``."""
    cfg = smoke_config("mamba2-130m")
    opt = make_optimizer(cfg)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt)
    mesh = make_host_mesh((1, 2), devices=["meta"] * 2)
    sh = state_shardings(state, mesh)
    del sh["opt"]                                 # left to ``device``
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        ckpt.save(state, 0)
        back = ckpt.restore(device="cpu", shardings=sh)
    for key, leaf in _flat(back).items():
        want = "cpu" if key.startswith("/opt") else "meta"
        assert leaf.device.type == want, key
    for key, leaf in _flat(back).items():
        if leaf.device.type == "cpu":
            assert torch.equal(leaf, _flat(state)[key]), key


def test_state_shardings_of_a_live_state_equal_those_of_its_shape():
    """state_shardings reads shapes only: the live smoke state and its
    eval_shape (fake tensors) give the same specs, and every leaf of the
    state has one."""
    cfg = smoke_config("mamba2-130m")
    opt = make_optimizer(cfg)
    mesh = make_host_mesh((2, 2), devices=["cpu"] * 4)

    def make():
        return init_state(torch.Generator().manual_seed(0), cfg, opt,
                          compress=True)

    live = _flat(state_shardings(make(), mesh))
    shaped = _flat(state_shardings(eval_shape(make), mesh))
    assert live.keys() == shaped.keys() == _flat(make()).keys()
    assert all(isinstance(s, NamedSharding) for s in live.values())
    assert {k: tuple(s.spec) for k, s in live.items()} == {
        k: tuple(s.spec) for k, s in shaped.items()}
    assert tuple(live["/params/layers/in_proj"].spec) == (None, "data",
                                                          "model")
    assert len(tree_leaves(make())) == len(live)
    assert np.all([s.device == torch.device("cpu") for s in live.values()])
