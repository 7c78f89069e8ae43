"""The port's dry run (``launch/dryrun.py``, ``launch/analysis.py``)
against the reference's on ten smoke cells of a (2, 4) mesh.

The reference's ``dryrun._measure`` runs once, in a subprocess with 8
forced host devices, on a ``make_host_mesh((2, 4))`` with
``scan_layers=False`` and ``remat="none"``: the six families' smoke
train cells and qwen2-1.5b's and mamba2-130m's prefill and decode, at 8
rows of 128 tokens.  Beside XLA's counts it writes the FLOPs of every
``dot_general`` in the step's jaxpr (sub-jaxprs walked, a scan body
times its length, a ``shard_map`` body times its shards).  The port
counts the same cells on a (2, 4) mesh of meta devices.

Both run the configs in fp32: XLA's CPU backend computes a bf16 model's
dots, and their collectives, in fp32, which a card does not, so at bf16
the comparison would measure that backend's upcast.

What is held:

* argument bytes a device: equal (nothing is padded: a spec shards a
  dimension only where it divides);
* the global matmul FLOPs with the plain scan: equal to the jaxpr's
  ``dot_general`` FLOPs less ``_matmul_difference``, each a difference
  by design (ROADMAP Queue 3);
* total FLOPs, bytes and collective bytes a device within
  ``FACTORS[family]``, each with its reason; the serving cells'
  all-reduce bytes within ``SERVE_ALLREDUCE_RTOL`` of GSPMD's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.config import ShapeConfig
from repro_torch.configs import smoke_config
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import ShardingRules

BATCH, SEQ = 8, 128
MESH = (2, 4)
# cell: (arch, kind); family from the config
CELLS = (
    ("qwen2-1.5b", "train"), ("llama4-scout-17b-a16e", "train"),
    ("mamba2-130m", "train"), ("recurrentgemma-9b", "train"),
    ("llava-next-mistral-7b", "train"), ("seamless-m4t-large-v2", "train"),
    ("qwen2-1.5b", "prefill"), ("qwen2-1.5b", "decode"),
    ("mamba2-130m", "prefill"), ("mamba2-130m", "decode"),
)

# Port over reference, per device: (flops, bytes, collective total) as
# (low, high) bands, measured on these cells (port / reference, fp32):
#   dense   train 1.026 0.932 0.646, prefill 1.069 1.009 0.852,
#           decode 0.647 0.326 0.065
#   moe     train 1.030 1.033 0.603
#   ssm     train 0.987 0.650 0.511, prefill 0.961 0.405 0.491,
#           decode 0.902 0.458 0.474
#   hybrid  train 0.971 1.112 0.974
#   vlm     train 1.025 0.957 0.715
#   audio   train 1.008 0.803 0.573
# FLOPs: the matmuls agree (below); both count an elementwise op an
# element, and differ on what XLA folds (converts, selects, the fused
# reductions' operands): within 10% where matmuls dominate (train,
# prefill); decode steps are mostly elementwise (caches, norms, the
# single-step recurrence) and XLA counts its cache updates' full
# buffers, 0.6-1.0.  Bytes: eager torch moves every op's operands, XLA
# counts its CPU module's (fused elementwise chains, bf16-free copies) and
# rewrites a whole cache or state buffer on an update the port does in
# place (index_copy_): 0.3-1.2, the SSM's and decode's low ends.
# Collectives: the specs' collectives against GSPMD's: within 0.5-2 for
# the train cells (GSPMD all-reduces FSDP gradients
# where the port reduce-scatters, and reshards activations with
# all-to-alls and permutes the specs do not call for); for serving, the
# all-reduces agree (SERVE_ALLREDUCE_RTOL) and the totals differ by
# GSPMD's own resharding: in decode it all-gathers the vocab-sharded
# embedding (524 KB a step, 0.065), in the SSM's serving it permutes the
# channel-sharded conv and scan inputs (0.47-0.49).
FACTORS = {
    ("dense", "train"): ((0.9, 1.1), (0.8, 1.1), (0.5, 2.0)),
    ("moe", "train"): ((0.9, 1.1), (0.9, 1.2), (0.5, 2.0)),
    ("ssm", "train"): ((0.9, 1.1), (0.55, 0.8), (0.5, 2.0)),
    ("hybrid", "train"): ((0.9, 1.1), (1.0, 1.25), (0.5, 2.0)),
    ("vlm", "train"): ((0.9, 1.1), (0.85, 1.1), (0.5, 2.0)),
    ("audio", "train"): ((0.9, 1.1), (0.7, 0.9), (0.5, 2.0)),
    ("dense", "prefill"): ((0.95, 1.15), (0.9, 1.1), (0.5, 2.0)),
    ("dense", "decode"): ((0.55, 0.75), (0.25, 0.4), (0.05, 2.0)),
    ("ssm", "prefill"): ((0.9, 1.05), (0.3, 0.5), (0.4, 2.0)),
    ("ssm", "decode"): ((0.8, 1.0), (0.35, 0.55), (0.4, 2.0)),
}
SERVE_ALLREDUCE_RTOL = 0.02


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), scan_layers=False,
                               remat="none", dtype="float32")


def _matmul_difference(arch, kind) -> int:
    """The reference's dot_general FLOPs less the port's matmul FLOPs, by
    design (ROADMAP Queue 3):

    * mamba2 decode: the single-step state update's outer product
      ``einsum("bgn,bghp->bghpn")`` is a dot_general with no contracted
      dimension in the jaxpr (2 FLOPs an output), a multiply in torch;
    * mamba2 train (plain scan): autograd does not differentiate what the
      loss does not read, the jaxpr does: the first chunk's read-out
      against its zero entering state (one product) and the last chunk's
      state update (two), 2 B Q H N P each, a layer;
    * scout train: the reference routes the tokens on every model rank
      inside its shard_map, the port once a batch shard: the router's
      forward and two backward products, (m - 1) times over."""
    cfg = _cfg(arch)
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        h, p, n = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
        if kind == "decode":
            return cfg.num_layers * 2 * BATCH * h * p * n
        if kind == "train":
            return cfg.num_layers * 3 * 2 * BATCH * cfg.ssm_chunk * h * n * p
    if cfg.is_moe and kind == "train":
        moe_layers = cfg.num_layers - cfg.first_k_dense
        return ((MESH[1] - 1) * 3 * 2 * BATCH * SEQ * cfg.d_model
                * cfg.num_experts * moe_layers)
    return 0


_ORACLE = """
import os, sys, json, dataclasses, math
import warnings; warnings.filterwarnings("ignore")
import jax
import jax.extend
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh
from repro.configs import smoke_config
from repro.config import ShapeConfig
from repro.models import api
from repro.sharding.rules import ShardingRules, sharding_context
from repro.train import train_step as TS
from repro.train.serve_step import make_serve_fns


def jaxprs(v):
    if isinstance(v, jax.extend.core.ClosedJaxpr):
        yield v.jaxpr
    elif isinstance(v, jax.extend.core.Jaxpr):
        yield v
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from jaxprs(x)


def dot_flops(jaxpr):
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += (2 * math.prod(eqn.outvars[0].aval.shape)
                      * math.prod(lhs[d] for d in lc))
        subs = [dot_flops(j) for v in eqn.params.values() for j in jaxprs(v)]
        if not subs:
            continue
        if name == "cond":
            total += max(subs)
            continue
        mult = eqn.params.get("length", 1) if name == "scan" else 1
        if name == "shard_map":
            shape = dict(eqn.params["mesh"].shape)
            mult = math.prod(shape[a] for a in eqn.params["manual_axes"])
        total += mult * sum(subs)
    return total


def jaxpr_dots(cfg, shape, mesh, kind):
    rules = ShardingRules()
    if kind != "train":
        rules = dataclasses.replace(rules, fsdp_axes=())
    with mesh, sharding_context(mesh, rules):
        key = jax.random.PRNGKey(0)
        if kind == "train":
            opt = TS.make_optimizer(cfg)
            st = jax.eval_shape(lambda: TS.init_state(key, cfg, opt))
            fn = TS.make_train_step(cfg, opt)
            args = (st, dryrun.input_specs(cfg, shape, "train"))
        else:
            ps = jax.eval_shape(lambda: api.init_params(key, cfg))
            cache = dryrun._cache_specs(cfg, shape)
            prefill_fn, decode_fn = make_serve_fns(cfg)
            if kind == "prefill":
                fn = prefill_fn
                args = (ps, dryrun.input_specs(cfg, shape, "prefill"), cache)
            else:
                fn = decode_fn
                args = (ps, dryrun.input_specs(cfg, shape, "decode")["tokens"],
                        cache)
        return dot_flops(jax.make_jaxpr(fn)(*args).jaxpr)


cells, batch, seq = json.loads(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
mesh = make_host_mesh((2, 4))
out = {}
for arch, kind in cells:
    cfg = dataclasses.replace(smoke_config(arch), scan_layers=False,
                              remat="none", dtype="float32")
    shape = ShapeConfig("smoke", seq, batch, kind)
    r = dryrun._measure(cfg, shape, mesh, ShardingRules(), kind)
    r["dot_flops"] = jaxpr_dots(cfg, shape, mesh, kind)
    r.pop("hlo_bytes", None)
    out[arch + "/" + kind] = r
print("ORACLE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's dry run of every cell, once, in a subprocess with
    8 forced host devices (about 50 s)."""
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_ORACLE),
         json.dumps(CELLS), str(BATCH), str(SEQ)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("ORACLE "))
    return json.loads(line[len("ORACLE "):])


@pytest.fixture(scope="module")
def port():
    """The port's counts of every cell on a (2, 4) meta mesh: the dry
    run's route (K5 counted as the kernel) and, for the SSM, the plain
    scan's (the other families run no kernel of ours: one route)."""
    mesh = make_host_mesh(MESH, devices=["meta"] * 8)
    out = {}
    for arch, kind in CELLS:
        shape = ShapeConfig("smoke", SEQ, BATCH, kind)
        routes = ("cuda", "torch") if _cfg(arch).family == "ssm" \
            else ("cuda",)
        out[f"{arch}/{kind}"] = {
            backend: dryrun._measure(_cfg(arch), shape, mesh,
                                     ShardingRules(), kind, backend=backend)
            for backend in routes}
        out[f"{arch}/{kind}"].setdefault("torch", out[f"{arch}/{kind}"]["cuda"])
    return out


def _ids(cells):
    return [f"{a}-{k}" for a, k in cells]


@pytest.mark.parametrize("arch,kind", CELLS, ids=_ids(CELLS))
def test_argument_bytes_equal_the_reference(reference, port, arch, kind):
    """Per-device argument bytes (state and batch; parameters, batch and
    cache when serving) from the specs equal XLA's
    argument_size_in_bytes."""
    ref = reference[f"{arch}/{kind}"]["memory"]["argument_size_in_bytes"]
    got = port[f"{arch}/{kind}"]["cuda"]["memory"]["argument_size_in_bytes"]
    assert got == ref


@pytest.mark.parametrize("arch,kind", CELLS, ids=_ids(CELLS))
def test_matmul_flops_equal_the_reference(reference, port, arch, kind):
    """With the plain scan, the port's global matmul FLOPs equal the
    reference jaxpr's dot_general FLOPs less the differences by design;
    the dry run's route counts the SSD scan as K5 and K5-bwd instead."""
    ref = reference[f"{arch}/{kind}"]["dot_flops"]
    plain = port[f"{arch}/{kind}"]["torch"]
    assert plain["matmul_flops_global"] == ref - _matmul_difference(
        arch, kind)
    cuda = port[f"{arch}/{kind}"]["cuda"]
    if _cfg(arch).family == "ssm" and kind != "decode":
        assert set(cuda["kernels"]) == ({"ssd_scan", "ssd_scan_bwd"}
                                        if kind == "train" else {"ssd_scan"})
        assert cuda["matmul_flops_global"] < plain["matmul_flops_global"]
    else:
        assert cuda["kernels"] == {}


@pytest.mark.parametrize("arch,kind", CELLS, ids=_ids(CELLS))
def test_totals_within_the_stated_factors(reference, port, arch, kind):
    """FLOPs, bytes and collective bytes a device, port over reference,
    within FACTORS (see the module docstring for each reason); the
    serving cells' all-reduces within SERVE_ALLREDUCE_RTOL."""
    ref = reference[f"{arch}/{kind}"]
    got = port[f"{arch}/{kind}"]["cuda"]
    bands = FACTORS[(_cfg(arch).family, kind)]
    ratios = (got["flops"] / ref["flops"], got["bytes"] / ref["bytes"],
              got["coll"]["total"] / ref["coll"]["total"])
    for what, r, (lo, hi) in zip(("flops", "bytes", "collectives"), ratios,
                                 bands):
        assert lo <= r <= hi, (what, r, (lo, hi))
    if kind != "train":
        ar_ref = ref["coll"].get("all-reduce", 0)
        ar = got["coll"].get("all-reduce", 0)
        assert abs(ar / ar_ref - 1) <= SERVE_ALLREDUCE_RTOL, (ar, ar_ref)


_FUNCTIONS = """
import sys, json, math
import warnings; warnings.filterwarnings("ignore")
from repro.configs import ARCH_IDS, get_config
from repro.config import SHAPES, cell_is_runnable
from repro.launch import analysis
hw = json.loads(sys.argv[1])
analysis.HW = {"peak_flops_bf16": hw["peak_flops_bf16"],
               "hbm_bw": hw["hbm_bw"], "ici_link_bw": hw["link_bw"],
               "hbm_bytes": hw["hbm_bytes"]}
triples = [(1e12, 1e9, 1e8), (3e9, 4e12, 0.0), (0.0, 0.0, 0.0), (5e14, 1e11, 2e11)]
out = {"terms": [analysis.roofline_terms(*t) for t in triples],
       "model_flops": {}, "runnable": {}, "summary": None}
for a in ARCH_IDS:
    cfg = get_config(a)
    for s, shape in SHAPES.items():
        out["model_flops"][a + "/" + s] = analysis.model_flops(cfg, shape, shape.kind)
        out["runnable"][a + "/" + s] = list(cell_is_runnable(cfg, shape))
row = {"arch": "a", "shape": "s", "mesh": "pod", "useful_flops_ratio": 0.5,
       "terms": analysis.roofline_terms(*triples[0]),
       "memory": {"per_device_total_gb": 1.25}}
out["summary"] = analysis.summarize(row)
out["row"] = row
print("FUNCTIONS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_functions():
    """The reference's roofline_terms over the port's HW table (patched in
    its subprocess; nothing in repro changes), model_flops and
    cell_is_runnable of every cell, and summarize of one row."""
    from repro_torch.config import HW

    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_FUNCTIONS), json.dumps(HW)],
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("FUNCTIONS "))
    return json.loads(line[len("FUNCTIONS "):])


def test_roofline_terms_equal_the_reference_on_h100_figures(
        reference_functions):
    triples = [(1e12, 1e9, 1e8), (3e9, 4e12, 0.0), (0.0, 0.0, 0.0),
               (5e14, 1e11, 2e11)]
    got = [analysis.roofline_terms(*t) for t in triples]
    assert got == reference_functions["terms"]


def test_model_flops_and_summarize_equal_the_reference(reference_functions):
    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCH_IDS, get_config

    for a in ARCH_IDS:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            assert analysis.model_flops(cfg, shape, shape.kind) == \
                reference_functions["model_flops"][f"{a}/{s}"]
    assert analysis.summarize(reference_functions["row"]) == \
        reference_functions["summary"]


def test_skipped_cells_are_the_references(reference_functions):
    """run_cell skips exactly the cells the reference's cell_is_runnable
    refuses, with its reason; nothing is counted for them."""
    from repro_torch.config import SHAPES
    from repro_torch.configs import ARCH_IDS

    skipped = 0
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = reference_functions["runnable"][f"{a}/{s}"]
            if ok:
                continue
            skipped += 1
            for mesh in ("pod", "multipod"):
                res = dryrun.run_cell(a, s, mesh, verbose=False)
                assert res == {"arch": a, "shape": s, "mesh": mesh,
                               "status": "skipped", "reason": why}
    assert skipped == 8
