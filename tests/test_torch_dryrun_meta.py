"""The dry run at full size on meta tensors, its plumbing, and the
kernels' meta branches.

* Full-size cells (one subprocess, so its peak RSS is the cells' own):
  each ends ``"ok"``, nothing of full size is allocated (the process's
  high-water RSS grows by less than ``RSS_GROWTH_BOUND``, where any
  full-size tensor of these cells is larger: Mamba2-130M's train state
  is 1.56 GB, llama3-8b's parameters 32 GB), and K5's and K5-bwd's
  counted work equals their work functions at the shapes the cell
  launches them at: the whole batch once a layer without sequence
  parallelism, every (batch, sequence) shard of the mesh with it, and K5
  once more in the backward under the config's ``remat="full"``.
* ``launch/train.py --mesh pod`` raises before anything is allocated;
  ``make_production_mesh`` has the reference's shapes and axes.
* K5's and K5-bwd's meta branch (as K1-K4 have): meta results of the
  kernel's shapes, the card's refusals, no launch, and the work handed
  to ``kernels.specs.abstract_launch``; K1-K4 hand theirs too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import specs
from repro_torch.kernels.cw_tis import (
    cw_tis_hscan_work, cw_tis_vscan_work, cw_tis_cuda,
)
from repro_torch.kernels.delta_apply import delta_apply_cuda, delta_apply_work
from repro_torch.kernels.fused_rows import fused_rows_cuda, fused_rows_work
from repro_torch.kernels.ssd_scan import (
    KERNEL_CHUNK, SSDScanFunction, ssd_scan_bwd_cuda, ssd_scan_bwd_work,
    ssd_scan_cuda, ssd_scan_work,
)
from repro_torch.kernels.wf_tis import wf_tis_cuda, wf_tis_work
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import make_production_mesh

RSS_GROWTH_BOUND = 1 << 30
# name: (arch, shape, mesh, config overrides)
FULL_CELLS = {
    "mamba-train-pod": ("mamba2-130m", "train_4k", "pod", {}),
    # sequence-parallel at its published widths, one layer (the 256
    # shards' per-layer work is what is checked; depth only repeats it)
    "mamba-train-pod-sp": ("mamba2-130m", "train_4k", "pod",
                           {"ssm_seq_parallel": True, "num_layers": 1}),
    "llama3-decode-pod": ("llama3-8b", "decode_32k", "pod", {}),
    "qwen2-decode-multipod": ("qwen2-1.5b", "decode_32k", "multipod", {}),
}

_CELLS = """
import sys, json
from repro_torch.launch import dryrun


def hwm():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) * 1024


cells = json.loads(sys.argv[1])
out = {"base": hwm()}
for name, (arch, shape, mesh, overrides) in cells.items():
    res = dryrun.run_cell(arch, shape, mesh, cfg_overrides=overrides,
                          verbose=False)
    out[name] = {"result": res, "hwm": hwm()}
print("CELLS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def full_cells():
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_CELLS),
         json.dumps(FULL_CELLS)],
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("CELLS "))
    return json.loads(line[len("CELLS "):])


def _k5_shape(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


@pytest.mark.parametrize("name", FULL_CELLS)
def test_full_size_cell_counts_on_meta(full_cells, name):
    arch, shape_name, mesh, overrides = FULL_CELLS[name]
    res = full_cells[name]["result"]
    assert res["status"] == "ok"
    assert res["chips"] == (512 if mesh == "multipod" else 256)
    assert full_cells[name]["hwm"] - full_cells["base"] < RSS_GROWTH_BOUND
    terms = res["terms"]
    assert terms["bound_s"] == max(terms["compute_s"], terms["memory_s"],
                                   terms["collective_s"]) > 0
    assert res["memory"]["argument_size_in_bytes"] > 0
    assert res["scan_correction"] == "none: every layer counted"
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collectives",
                "collective_counts", "model_flops_6nd",
                "useful_flops_ratio"):
        assert key in res
    cfg = get_config(arch)
    if cfg.family != "ssm":
        assert res["kernels"] == {}
        return
    # K5 and K5-bwd at the shapes the cell launches them at.
    from repro_torch.config import SHAPES

    shape = SHAPES[shape_name]
    layers = overrides.get("num_layers", cfg.num_layers)
    h, p, n = _k5_shape(cfg)
    if overrides.get("ssm_seq_parallel"):
        # batch over the data axis (16), sequence over the model axis (16);
        # every shard's h_last but the last rank's feeds the ladder
        b, s, ranks, rows = (shape.global_batch // 16, shape.seq_len // 16,
                             16, 16)
    else:
        b, s, ranks, rows = shape.global_batch, shape.seq_len, 1, 1
    # The config's remat="full" runs each layer's forward again in the
    # backward, K5 included: twice the forward's calls.
    fwd = [ssd_scan_work(b, s, h, p, n)] * (ranks * rows)
    fwd = fwd * {"full": 2, "dots": 1, "none": 1}[cfg.remat]
    bwd = [ssd_scan_bwd_work(b, s, h, p, n, g_hlast=i < ranks - 1)
           for _ in range(rows) for i in range(ranks)]
    want = {"ssd_scan": {"calls": layers * len(fwd),
                         "bytes": layers * sum(w["bytes"] for w in fwd),
                         "flops": layers * sum(w["flops"] for w in fwd)},
            "ssd_scan_bwd": {"calls": layers * len(bwd),
                             "bytes": layers * sum(w["bytes"] for w in bwd),
                             "flops": layers * sum(w["flops"] for w in bwd)}}
    assert res["kernels"] == want
    if overrides.get("ssm_seq_parallel"):
        assert res["collectives"]["collective-permute"] > 0


def test_dryrun_cli_writes_one_json_a_cell(tmp_path):
    """``main`` with the reference's flags writes the reference's field
    names; an existing file is skipped unless --force."""
    out = tmp_path / "dr"
    argv = ["--arch", "llama3-8b", "--shape", "decode_32k", "--mesh", "pod",
            "--out", str(out), "--tag", "t", "--override",
            "flash_min_seq=4096"]
    assert dryrun.main(argv) == 0
    path = out / "llama3-8b__decode_32k__pod__t.json"
    res = json.loads(path.read_text())
    assert res["status"] == "ok" and res["variant"]["tag"] == "t"
    assert res["variant"]["overrides"] == {"flash_min_seq": 4096}
    for key in ("terms", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collectives",
                "collective_counts", "model_flops_6nd",
                "useful_flops_ratio", "count_s"):
        assert key in res
    assert res["memory"]["per_device_total_gb"] > 0
    path.write_text("{}")
    assert dryrun.main(argv) == 0
    assert path.read_text() == "{}"


def test_production_mesh_shapes_and_refusal():
    pod = make_production_mesh(devices=["meta"] * 256)
    assert pod.shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert all(d.type == "meta" for d in multi.devices.flat)
    if torch.cuda.device_count() < 256:
        with pytest.raises(ValueError, match="256 cards"):
            make_production_mesh()
        with pytest.raises(ValueError, match="512 cards"):
            make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError):
        make_production_mesh(devices=["meta"] * 8)


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_train_mesh_pod_raises_before_any_allocation(monkeypatch, mesh):
    """On a host with fewer cards than the mesh, --mesh pod|multipod
    raises make_production_mesh's ValueError before a state, a stream or a
    step exists."""
    def refuse(*args, **kwargs):
        raise AssertionError("allocated before the mesh was refused")

    for name in ("init_state", "make_stream", "make_train_step",
                 "make_optimizer"):
        monkeypatch.setattr(train_launch, name, refuse)
    with pytest.raises(ValueError, match="cards"):
        train_launch.main(["--smoke", "--mesh", mesh, "--steps", "1"])


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _k5_inputs(b=2, s=256, h=3, p=16, n=8, g=1):
    return (_meta(b, s, h, p), _meta(b, s, h), _meta(h), _meta(b, s, g, n),
            _meta(b, s, g, n))


class _Seen:
    """Records what the kernels hand ``specs.abstract_launch``."""

    def __enter__(self):
        self.calls = []
        specs.ABSTRACT_LAUNCH_OBSERVERS.append(self._seen)
        return self

    def _seen(self, name, work):
        self.calls.append((name, work))

    def __exit__(self, *exc):
        specs.ABSTRACT_LAUNCH_OBSERVERS.remove(self._seen)
        return False


@pytest.mark.parametrize("with_h0", [False, True])
def test_k5_meta_branch_shapes_and_work(with_h0):
    b, s, h, p, n = 2, 200, 3, 16, 8
    x, dt, A, Bm, Cm = _k5_inputs(b, s, h, p, n)
    h0 = _meta(b, h, n, p) if with_h0 else None
    before = (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches)
    with _Seen() as seen:
        y, h_last, states = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=200, h0=h0,
                                          return_states=True)
        y2, h2 = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=200, h0=h0)
        grads = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, _meta(b, s, h, p),
                                  states=states, chunk=200, h0=h0,
                                  g_hlast=_meta(b, h, n, p))
    chunks = -(-s // KERNEL_CHUNK)
    assert [t.shape for t in (y, h_last, states, y2, h2)] == [
        (b, s, h, p), (b, h, n, p), (b, h, chunks, n, p), (b, s, h, p),
        (b, h, n, p)]
    assert all(t.is_meta and t.dtype == torch.float32
               for t in (y, h_last, states))
    want = [x.shape, dt.shape, A.shape, Bm.shape, Cm.shape,
            h0.shape if with_h0 else None]
    assert [None if t is None else t.shape for t in grads] == want
    assert (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches) == before
    fwd = ssd_scan_work(b, s, h, p, n, h0=with_h0)
    assert seen.calls == [
        ("ssd_scan", fwd), ("ssd_scan", fwd),
        ("ssd_scan_bwd", ssd_scan_bwd_work(b, s, h, p, n, h0=with_h0,
                                           g_hlast=True))]


def test_k5_meta_branch_refuses_what_the_card_refuses():
    with pytest.raises(NotImplementedError, match="G=2"):
        ssd_scan_cuda(*_k5_inputs(h=4, g=2), chunk=256)
    with pytest.raises(NotImplementedError, match="multiples of 4"):
        ssd_scan_cuda(*_k5_inputs(p=6), chunk=256)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan_cuda(*_k5_inputs(s=100), chunk=64)
    x, dt, A, Bm, Cm = _k5_inputs()
    with pytest.raises(ValueError, match="states"):
        ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, _meta(*x.shape),
                          states=_meta(2, 3, 1, 8, 16), chunk=256)


def test_ssd_function_on_meta_counts_k5_and_k5_bwd():
    """SSDScanFunction's forward and backward take the meta branches:
    autograd gets meta gradients of the inputs' shapes, nothing launches."""
    b, s, h, p, n = 2, 128, 2, 8, 8
    x, dt, A, Bm, Cm = (t.requires_grad_() for t in _k5_inputs(b, s, h, p, n))
    before = (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches)
    with _Seen() as seen:
        y, _ = SSDScanFunction.apply(x, dt, A, Bm, Cm, None, 128)
        y.sum().backward()
    assert [name for name, _ in seen.calls] == ["ssd_scan", "ssd_scan_bwd"]
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (x, dt, A, Bm, Cm))
    assert (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches) == before


def test_k1_to_k4_hand_their_work_to_the_observers():
    n, h, w, nb = 2, 40, 48, 8
    ids = _meta(n, h, w, dtype=torch.int32)
    rows = np.array([3, 17, 39])
    H = _meta(n, nb, h, w)
    with _Seen() as seen:
        wf_tis_cuda(ids, nb, carry=_meta(n, nb, w))
        fused_rows_cuda(ids, nb, rows)
        delta_apply_cuda(H, _meta(n, nb, w))
        cw_tis_cuda(ids, nb)
    assert seen.calls == [
        ("wf_tis", wf_tis_work(n, h, w, nb, carry=True)),
        ("fused_rows", fused_rows_work(n, w, nb, rows)),
        ("delta_apply", delta_apply_work(H.numel(), n * nb * w)),
        ("cw_tis_hscan", cw_tis_hscan_work(n, h, w, nb)),
        ("cw_tis_vscan", cw_tis_vscan_work(n, nb, h, w)),
    ]
