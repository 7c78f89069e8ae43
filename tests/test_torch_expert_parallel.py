"""The port's expert-parallel MoE (``models/moe.moe_block`` under a
sharding context) and ``train/grad.compressed_psum`` against the
reference's own mesh paths.

The reference's ``shard_map`` paths run in one subprocess with 8 forced
host devices (its ``test_expert_parallel_moe_matches_local`` and
``test_compressed_psum_accuracy`` pass on this host), on the same numpy
inputs and the reference's weights; the port runs in this process on a
``device.Mesh`` of CPU entries.  Tolerances: the MoE output within
OUT_ATOL (outputs up to ~0.04; the model ranks' partials are summed in
another order, largest measured 9.3e-9), aux within AUX_RTOL (measured
0), the int8 all-reduce within PSUM_ATOL of the reference's (the same
quantized values and scales, summed in another order; largest measured
1.5e-8).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.moe import moe_block
from repro_torch.sharding import sharding_context
from repro_torch.train.grad import compressed_psum

OUT_ATOL = 1e-6
AUX_RTOL = 1e-6
PSUM_ATOL = 1e-7

# name: (arch, config overrides, mesh shape (data, model))
CASES = {
    # the reference test's case: no token over capacity
    "kimi-cf8": ("kimi-k2-1t-a32b", {"capacity_factor": 8.0}, (2, 4)),
    # a capacity that binds: each shard's capacity comes from its local
    # token count, so the drops differ from the mesh-free path's
    "kimi-cf0.5": ("kimi-k2-1t-a32b", {"capacity_factor": 0.5}, (2, 4)),
    "scout-cf1": ("llama4-scout-17b-a16e", {"capacity_factor": 1.0}, (4, 2)),
    # a shared expert whose ff dim (30) the model axis (4) does not
    # divide: it runs whole, added after the sum over ranks
    "kimi-odd-shared": ("kimi-k2-1t-a32b",
                        {"capacity_factor": 2.0, "expert_d_ff": 30}, (2, 4)),
}
PSUM_AXES = {"pod8": ((8,), ("pod",), "pod"),
             "model4": ((2, 4), ("data", "model"), "model")}

_ORACLE = """
import warnings; warnings.filterwarnings("ignore")
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.models.moe import moe_block, moe_params
from repro.sharding.rules import sharding_context
from repro.train.grad import compressed_psum
cases, psum_axes = eval(sys.argv[2]), eval(sys.argv[3])
out = {}
for name, (arch, kw, shape) in cases.items():
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              d_model=64, **kw)
    p = moe_params(jax.random.PRNGKey(1), cfg)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (8, 8, 64)).astype(np.float32) * 0.1)
    local, aux_l = moe_block(x, p, cfg)
    mesh = jax.make_mesh(shape, ("data", "model"))
    with mesh, sharding_context(mesh):
        ep, aux_s = jax.jit(lambda x, p: moe_block(x, p, cfg))(x, p)
    out[name + "/x"] = np.asarray(x)
    for k, v in p.items():
        out[name + "/p/" + k] = np.asarray(v)
    out[name + "/local"], out[name + "/ep"] = np.asarray(local), np.asarray(ep)
    out[name + "/aux_local"] = np.asarray(aux_l)
    out[name + "/aux_ep"] = np.asarray(aux_s)
for name, (shape, axes, axis) in psum_axes.items():
    d = dict(zip(axes, shape))[axis]
    parts = np.random.default_rng(0).normal(size=(d, 128)) * 1e-3
    parts[1] *= 40.0          # one rank's part far larger than the rest
    mesh = jax.make_mesh(shape, axes)
    out[name + "/parts"] = parts.astype(np.float32)
    out[name + "/sum"] = np.asarray(compressed_psum(jnp.asarray(
        parts.astype(np.float32)), mesh, axis))
np.savez(sys.argv[1], **out)
print("oracle OK")
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's mesh paths, once, in a subprocess with 8 forced
    host devices."""
    path = tmp_path_factory.mktemp("ep") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_ORACLE), str(path),
         repr(CASES), repr(PSUM_AXES)],
        env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "oracle OK" in proc.stdout
    with np.load(path) as f:
        return dict(f)


def _cpu_mesh(shape, axes=("data", "model")):
    return make_host_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


@pytest.mark.parametrize("name", CASES)
def test_expert_parallel_moe_matches_reference_mesh_path(oracle, name):
    """moe_block under a context on a (data, model) mesh of CPU entries:
    output and aux equal the reference's shard_map path; the mesh-free
    path equals the reference's mesh-free one."""
    arch, kw, shape = CASES[name]
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              d_model=64, **kw)
    x = torch.as_tensor(oracle[f"{name}/x"])
    p = {k.split("/")[-1]: torch.as_tensor(v) for k, v in oracle.items()
         if k.startswith(f"{name}/p/")}
    local, aux_l = moe_block(x, p, cfg)
    with sharding_context(_cpu_mesh(shape)):
        ep, aux_s = moe_block(x, p, cfg)
    np.testing.assert_allclose(local.numpy(), oracle[f"{name}/local"],
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(ep.numpy(), oracle[f"{name}/ep"],
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux_l), oracle[f"{name}/aux_local"],
                               rtol=AUX_RTOL)
    np.testing.assert_allclose(float(aux_s), oracle[f"{name}/aux_ep"],
                               rtol=AUX_RTOL)
    gap = float(np.abs(oracle[f"{name}/ep"] - oracle[f"{name}/local"]).max())
    if name == "kimi-cf0.5":      # the binding capacity shows
        assert gap > 1e-3, gap
    elif name == "kimi-cf8":
        assert gap < 1e-4, gap


@pytest.mark.parametrize("name", PSUM_AXES)
def test_compressed_psum_matches_reference(oracle, name):
    """compressed_psum over a mesh axis of CPU entries equals the
    reference's shard_map all-reduce, and stays within the int8
    quantization's error of the exact sum (a relative 2%, the reference's
    bound)."""
    shape, axes, axis = PSUM_AXES[name]
    parts = torch.as_tensor(oracle[f"{name}/parts"])
    got = compressed_psum(parts, _cpu_mesh(shape, axes), axis)
    np.testing.assert_allclose(got.numpy(), oracle[f"{name}/sum"],
                               atol=PSUM_ATOL, rtol=0)
    exact = parts.double().sum(0)
    assert float((got - exact).norm() / exact.norm()) < 0.02
    assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        compressed_psum(parts[:-1], _cpu_mesh(shape, axes), axis)
