"""repro_torch's CUDA kernels against their plain versions, on the GPU.

Every test here needs a CUDA device and skips without one; the skip is
decided when the test runs, not when the module is imported.  This file
imports neither JAX nor the reference, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.engine import (
    HistogramEngine,
    LikelihoodQuery,
    RegionQuery,
    SlidingWindowQuery,
)
from repro_torch.kernels import ops
from repro_torch.kernels.cw_tis import (
    cw_tis_cuda,
    cw_tis_hscan_cuda,
    cw_tis_hscan_plain,
    cw_tis_plain,
    cw_tis_vscan_cuda,
)
from repro_torch.kernels.delta_apply import delta_apply_cuda, delta_apply_plain
from repro_torch.kernels.fused_rows import (
    check_rows,
    chunk_shape,
    fused_rows_cuda,
    fused_rows_plain,
)
from repro_torch.kernels.fused_rows import launch as k2_launch
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.kernels.wf_tis import (
    launch,
    launch_shape,
    wf_tis_cuda,
    wf_tis_plain,
)

torch.set_num_threads(1)


def _carry(seed, shape, bins):
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 1000, shape[:-2] + (bins, shape[-1])).astype(
        np.float32)


@pytest.fixture
def cuda_device():
    """Skip unless a GPU is present (decided at run time, not import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,bins,with_carry", [
    (1, 1, 1, 1, False), (3, 97, 131, 32, True), (2, 33, 4099, 3, True),
])
def test_cuda_kernels_equal_plain(cuda_device, n, h, w, bins, with_carry):
    rng = np.random.default_rng(10)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (n, h, w)),
                          dtype=torch.int32, device=cuda_device)
    carry = (torch.as_tensor(_carry(10, (n, h, w), bins), device=cuda_device)
             if with_carry else None)
    before = wf_tis_cuda.launches
    H = wf_tis_cuda(idx, bins, carry=carry)
    assert wf_tis_cuda.launches > before
    want = wf_tis_plain(idx, bins, carry)
    assert torch.equal(H, want)
    rows = np.unique(rng.integers(0, h, 5))
    R = fused_rows_cuda(idx, bins, rows, carry=carry)
    assert torch.equal(R, want[..., torch.as_tensor(rows, device=cuda_device), :])


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("h,w,strip_rows", [
    (31, 640, 32), (32, 640, 32), (33, 640, 32), (1, 640, 32),
    (97, 131, 5), (64, 4099, 1),
])
@pytest.mark.parametrize("bin_block", [1, 2, 4, 8])
def test_k1_strip_boundaries_equal_plain(cuda_device, bin_block, h, w,
                                         strip_rows, with_carry):
    """K1 cut into strips of ``strip_rows`` rows (counts pre-pass, then
    seeded walks) equals the plain version bit for bit at heights R - 1,
    R, R + 1 and 1, ragged widths, every bin block."""
    bins = 32
    rng = np.random.default_rng(16)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (1, h, w)),
                          dtype=torch.int32, device=cuda_device)
    carry = (torch.as_tensor(_carry(16, (1, h, w), bins), device=cuda_device)
             if with_carry else None)
    shape = launch_shape(w, bins, 1, bin_block, h=h, strip_rows=strip_rows)
    got = launch(idx, bins, shape, carry)
    assert torch.equal(got, wf_tis_plain(idx, bins, carry))


@pytest.mark.parametrize("n,h,w,bins,with_carry", [
    (1, 480, 640, 32, False),       # one frame: strips
    (1, 48, 640, 32, True),         # a dirty run with its carry: one strip
    (1, 273, 3840, 128, True),      # a band of the 4K frame: one strip
    (16, 480, 640, 32, False),      # the clip: one strip
])
def test_k1_path_shapes_equal_plain(cuda_device, n, h, w, bins, with_carry):
    rng = np.random.default_rng(17)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (n, h, w)),
                          dtype=torch.int32, device=cuda_device)
    carry = (torch.as_tensor(_carry(17, (n, h, w), bins), device=cuda_device)
             if with_carry else None)
    before = wf_tis_cuda.launches
    got = wf_tis_cuda(idx, bins, carry=carry)
    assert wf_tis_cuda.launches == before + 1     # one call, however cut
    assert torch.equal(got, wf_tis_plain(idx, bins, carry))


def _k2_case(device, seed, n, h, w, bins, with_carry):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (n, h, w)),
                          dtype=torch.int32, device=device)
    carry = (torch.as_tensor(_carry(seed, (n, h, w), bins), device=device)
             if with_carry else None)
    return idx, carry


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("w", [1, 131, 640, 4099])
@pytest.mark.parametrize("bin_block", [1, 2, 4, 8])
def test_k2_bin_blocks_and_widths_equal_plain(cuda_device, bin_block, w,
                                              with_carry):
    """K2 at every bin block, at widths that take scalar and 16-byte
    accesses and one (4099) that pass A covers in three column slabs;
    rows 0 and h - 1, a run of consecutive rows and a long segment."""
    idx, carry = _k2_case(cuda_device, 30, 2, 70, w, 32, with_carry)
    rows = np.array([0, 1, 2, 3, 9, 40, 69])
    before = fused_rows_cuda.launches
    got = fused_rows_cuda(idx, 32, rows, bin_block=bin_block, carry=carry)
    assert fused_rows_cuda.launches == before + 1
    assert torch.equal(got, fused_rows_plain(idx, 32, rows, carry))


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("n,h,rows", [
    (1, 64, (0, 17, 40)),                   # the first row
    (1, 64, (5, 33, 63)),                   # the last row
    (1, 64, (20, 21, 22, 23, 50)),          # chunks of one row
    (3, 64, (31,)),                         # a single row
    (1, 480, (2, 470)),                     # long segments: 7-row chunks
    (16, 480, (2, 470)),                    # the same in 94-row chunks
    (2, 1, (0,)),                           # h = 1
    (40, 480, (2, 470)),                    # 468 rows: two 234-row chunks
    (1, 480, tuple(range(3, 480, 4))),      # 120 rows of 480: the fuse bound
    (16, 480, tuple(range(3, 480, 4))),     # the same on 16 frames, in place
    (1, 480, (99, 219)),                    # one frame, one rect
])
def test_k2_row_sets_equal_plain(cuda_device, n, h, rows, with_carry):
    idx, carry = _k2_case(cuda_device, 31, n, h, 640, 32, with_carry)
    got = fused_rows_cuda(idx, 32, rows, carry=carry)
    assert torch.equal(got, fused_rows_plain(idx, 32, rows, carry))


@pytest.mark.parametrize("bin_block", [2, 8])
@pytest.mark.parametrize("chunk_rows", [1, 3, 70])
@pytest.mark.parametrize("w,rows", [
    (640, (0, 1, 2, 9, 30, 31, 47, 69)),
    (4099, (5, 6, 40, 69)),                 # three column slabs a chunk
    (640, (60, 69)),                        # 61 rows: 8 row batches a chunk
])
def test_k2_chunk_cuts_equal_plain(cuda_device, bin_block, chunk_rows, w,
                                   rows):
    """Chunks of at most ``chunk_rows`` rows, from rows one at a time to
    whole segments (several row batches a chunk), give the same rows."""
    idx, carry = _k2_case(cuda_device, 33, 2, 70, w, 32, True)
    rows = check_rows(rows, 70)
    shape = chunk_shape(w, 32, 2, rows.size, int(rows[-1]) + 1,
                        bin_block)._replace(chunk_rows=chunk_rows)
    got = k2_launch(idx, 32, rows, shape, carry)
    assert torch.equal(got, fused_rows_plain(idx, 32, rows, carry))


@pytest.mark.parametrize("chunk_rows,rows", [
    (255, (254, 299)),          # a chunk of 255 rows, the most a byte counts
    (255, (40, 299)),           # a segment of 259 rows: two chunks
])
def test_k2_counts_fill_a_byte(cuda_device, chunk_rows, rows):
    """Every id in one bin: pass A's packed counts reach 255 in a column
    and must not carry into the next bin's byte."""
    for value in (0, 3, 4, 7, 31):
        idx = torch.full((1, 300, 131), value, dtype=torch.int32,
                         device=cuda_device)
        rows_ = check_rows(rows, 300)
        shape = chunk_shape(131, 32, 1, rows_.size, 300)._replace(
            chunk_rows=chunk_rows)
        got = k2_launch(idx, 32, rows_, shape)
        assert torch.equal(got, fused_rows_plain(idx, 32, rows_))
    with pytest.raises(ValueError, match="chunk_rows"):
        k2_launch(idx, 32, rows_, shape._replace(chunk_rows=256))


def test_one_frame_fused_request_launches_k2_once(cuda_device):
    """A real-time stream's request: one 480x640 frame, one rect.  It plans
    fused (rows 99 and 219) and launches K2 once, K1 never."""
    frame = np.random.default_rng(32).integers(0, 256, (480, 640), np.uint8)
    queries = [RegionQuery(np.array([[100, 120, 219, 279]]))]
    _zero_counts()
    got = HistogramEngine(num_bins=32).run(frame, queries)
    counts = _counts()
    assert got.plan.representation == "fused"
    assert list(got.plan.spec.query_rows) == [99, 219]
    assert counts == {"wf_tis": 0, "fused_rows": 1, "delta_apply": 0,
                      "cw_tis_hscan": 0, "cw_tis_vscan": 0}, counts
    want = HistogramEngine(num_bins=32, backend="torch").run(frame, queries)
    assert torch.equal(got.results[0], want.results[0])


def test_engine_on_the_card_launches_the_kernels(cuda_device):
    frames = np.random.default_rng(11).integers(0, 256, (2, 64, 80),
                                                np.uint8)
    eng = HistogramEngine(num_bins=8)

    def counted(*args):
        # Each path's own counts: set to 0 just before, read just after.
        wf_tis_cuda.launches = fused_rows_cuda.launches = 0
        out = eng.run(frames, *args)
        return out, (wf_tis_cuda.launches, fused_rows_cuda.launches)

    fused, fused_counts = counted([RegionQuery(np.array([[3, 4, 40, 60]]))])
    dense, dense_counts = counted()
    assert fused.plan.representation == "fused"
    assert dense.plan.representation == "dense"
    assert fused_counts == (0, 1)        # (wf_tis, fused_rows)
    assert dense_counts == (1, 0)
    plain = HistogramEngine(num_bins=8, backend="torch").run(
        frames, [RegionQuery(np.array([[3, 4, 40, 60]]))])
    assert torch.equal(fused.results[0], plain.results[0])


def _counts():
    return {"wf_tis": wf_tis_cuda.launches,
            "fused_rows": fused_rows_cuda.launches,
            "delta_apply": delta_apply_cuda.launches,
            "cw_tis_hscan": cw_tis_hscan_cuda.launches,
            "cw_tis_vscan": cw_tis_vscan_cuda.launches}


def _zero_counts():
    for fn in (wf_tis_cuda, fused_rows_cuda, delta_apply_cuda,
               cw_tis_hscan_cuda, cw_tis_vscan_cuda):
        fn.launches = 0


@pytest.mark.parametrize("n,b,h,w", [
    (1, 1, 1, 1), (2, 3, 17, 131), (3, 32, 40, 640), (1, 5, 9, 4099),
])
def test_delta_apply_kernel_equals_plain(cuda_device, n, b, h, w):
    rng = np.random.default_rng(12)
    H = torch.as_tensor(rng.integers(0, 1 << 20, (n, b, h, w)),
                        dtype=torch.float32, device=cuda_device)
    d = torch.as_tensor(rng.integers(-5000, 5000, (n, b, w)),
                        dtype=torch.float32, device=cuda_device)
    before = delta_apply_cuda.launches
    assert torch.equal(delta_apply_cuda(H, d), delta_apply_plain(H, d))
    assert delta_apply_cuda.launches == before + 1
    # A row band of H, written straight into a row band of another H.
    if h > 4:
        out = torch.zeros_like(H)
        got = delta_apply_cuda(H[:, :, 2:h - 1], d, out=out[:, :, 1:h - 2])
        assert got.data_ptr() == out[:, :, 1:h - 2].data_ptr()
        assert torch.equal(out[:, :, 1:h - 2],
                           delta_apply_plain(H[:, :, 2:h - 1], d))
        assert not out[:, :, :1].any() and not out[:, :, h - 2:].any()


@pytest.mark.parametrize("n,h,w,bins,with_carry", [
    (1, 1, 1, 1, False), (3, 97, 131, 32, True), (2, 33, 4099, 3, True),
    (2, 130, 640, 32, False),
])
def test_cw_tis_kernels_equal_plain_and_k1(cuda_device, n, h, w, bins,
                                           with_carry):
    rng = np.random.default_rng(13)
    idx = torch.as_tensor(rng.integers(-1, bins + 1, (n, h, w)),
                          dtype=torch.int32, device=cuda_device)
    carry = (torch.as_tensor(_carry(13, (n, h, w), bins), device=cuda_device)
             if with_carry else None)
    before = (cw_tis_hscan_cuda.launches, cw_tis_vscan_cuda.launches)
    hh = cw_tis_hscan_cuda(idx, bins)
    assert torch.equal(hh, cw_tis_hscan_plain(idx, bins))
    H = cw_tis_cuda(idx, bins, carry=carry)
    assert (cw_tis_hscan_cuda.launches, cw_tis_vscan_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(H, cw_tis_plain(idx, bins, carry))
    assert torch.equal(H, wf_tis_cuda(idx, bins, carry=carry))


def test_incremental_stream_launches_k3_not_k2(cuda_device):
    rng = np.random.default_rng(14)
    prev = rng.integers(0, 256, (64, 80), np.uint8)
    eng = HistogramEngine(num_bins=8)
    target = np.full(8, 8.0, np.float32)
    queries = [LikelihoodQuery(target, (8, 8), stride=2)]
    out = eng.run(prev, queries)
    assert out.plan.representation == "dense"
    for r0 in (16, 56):            # clean rows below, then none below
        nxt = prev.copy()
        nxt[r0:r0 + 8] = rng.integers(0, 256, (8, 80), np.uint8)
        _zero_counts()
        new = eng.run(nxt, queries, prev=(prev, out))
        counts = _counts()
        assert new.plan.incremental and new.plan.representation == "dense"
        assert counts == {"wf_tis": 1, "fused_rows": 0,
                          "delta_apply": int(r0 + 8 < 64),
                          "cw_tis_hscan": 0, "cw_tis_vscan": 0}, counts
        fresh = eng.compute_dense(nxt)
        assert torch.equal(new.source.dense(), fresh)
        plain = HistogramEngine(num_bins=8, backend="torch").run(nxt, queries)
        assert torch.allclose(new.results[0], plain.results[0], rtol=1e-6,
                              atol=1e-7)
        prev, out = nxt, new


def test_cw_tis_engine_launches_k4_not_k1(cuda_device):
    frames = np.random.default_rng(15).integers(0, 256, (2, 64, 80),
                                                np.uint8)
    queries = [SlidingWindowQuery((4, 4), 2)]
    _zero_counts()
    got = HistogramEngine(num_bins=8, method="cw_tis").run(frames, queries)
    counts = _counts()
    assert got.plan.representation == "dense"
    assert counts == {"wf_tis": 0, "fused_rows": 0, "delta_apply": 0,
                      "cw_tis_hscan": 1, "cw_tis_vscan": 1}, counts
    want = HistogramEngine(num_bins=8).run(frames, queries)
    assert torch.equal(got.results[0], want.results[0])
    assert torch.equal(got.source.dense(), want.source.dense())


# K5 against its plain version: 3xTF32 tensor-core products (about fp32)
# in another order and 64-step chunks inside the kernel against the plain
# chunk loop (cuBLAS fp32, TF32 off).
SSD_ATOL, SSD_RTOL = 1e-4, 1e-4


def _ssd_inputs(seed, b, s, h, p, n, g=1, with_h0=False, device="cuda"):
    r = np.random.default_rng(seed)
    arrays = [
        r.standard_normal((b, s, h, p)),
        np.log1p(np.exp(r.standard_normal((b, s, h)))),
        -np.exp(r.standard_normal(h) * 0.2),
        r.standard_normal((b, s, g, n)) * 0.3,
        r.standard_normal((b, s, g, n)) * 0.3,
        r.standard_normal((b, h, n, p)) if with_h0 else None,
    ]
    return [None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                   device=device)
            for a in arrays]


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (1, 1, 1, 4, 4, 1, False), (2, 100, 3, 8, 16, 25, True),
    (1, 320, 2, 64, 128, 64, False), (4, 1024, 24, 64, 128, 256, True),
])
def test_ssd_scan_kernel_equals_plain(cuda_device, no_tf32, b, s, h, p, n,
                                      chunk, with_h0):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(20, b, s, h, p, n, with_h0=with_h0)
    before = ssd_scan_cuda.launches
    y, h_last = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    y_want, h_want = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, y_want, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(h_last, h_want, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("b,h", [(1, 2), (4, 24)])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 64), (65, 13), (1000, 200),
                                     (4096, 256)])
def test_ssd_scan_kernel_chunk_edges(cuda_device, no_tf32, s, chunk, with_h0,
                                     b, h):
    """One chunk, one step past it, a ragged last chunk and a long
    sequence, at a small and at the prefill's B x H (P=64, N=128)."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(24, b, s, h, 64, 128,
                                       with_h0=with_h0)
    before = ssd_scan_cuda.launches
    y, h_last = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    y_want, h_want = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.testing.assert_close(y, y_want, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(h_last, h_want, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_scan_kernel_reads_strided_inputs(cuda_device, no_tf32):
    """x, B and C as the model hands them over in fp32: views into one
    (B, S, d_in + 2N) activation."""
    b, s, h, p, n = 2, 130, 4, 16, 32
    r = np.random.default_rng(21)
    xbc = torch.as_tensor(r.standard_normal((b, s, h * p + 2 * n)),
                          dtype=torch.float32, device=cuda_device)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    Bm = xbc[..., h * p:h * p + n].reshape(b, s, 1, n) * 0.3
    Cm = xbc[..., h * p + n:].reshape(b, s, 1, n)
    dt = torch.rand((b, s, h), device=cuda_device)
    A = -torch.rand((h,), device=cuda_device)
    y, h_last = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=10)
    y_c, h_c = ssd_scan_cuda(x.contiguous(), dt, A, Bm.contiguous(),
                             Cm.contiguous(), chunk=10)
    assert torch.equal(y, y_c) and torch.equal(h_last, h_c)
    y_want, _ = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=10)
    torch.testing.assert_close(y, y_want, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_chunked_on_the_card(cuda_device, no_tf32):
    from repro_torch.models.ssm import ssd_chunked

    x, dt, A, Bm, Cm, h0 = _ssd_inputs(22, 2, 1000, 3, 64, 128,
                                       with_h0=True)
    y, h_last = ssd_chunked(x, dt, A, Bm, Cm, 256, h0=h0)
    y_want, h_want = ssd_chunked(x, dt, A, Bm, Cm, 256, h0=h0,
                                 backend="torch")
    torch.testing.assert_close(y, y_want, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(h_last, h_want, atol=SSD_ATOL, rtol=SSD_RTOL)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(23, 1, 32, 4, 8, 16, g=2)
    with pytest.raises(NotImplementedError, match="G=2"):
        ssd_chunked(x, dt, A, Bm, Cm, 16)


def test_mamba2_prefill_launches_k5_once_per_layer(cuda_device, no_tf32):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import make_request
    from repro_torch.models import api

    cfg = dataclasses.replace(smoke_config("mamba2-130m"), dtype="float32")
    params, request = make_request(cfg, 2, 40, seed=0)
    prompts = request["tokens"]
    cache = api.init_cache(cfg, 2, 48)
    ssd_scan_cuda.launches = 0
    logits, cache = api.prefill(params, {"tokens": prompts}, cfg, cache)
    assert ssd_scan_cuda.launches == cfg.num_layers
    want, _ = api.prefill(params, {"tokens": prompts}, cfg,
                          api.init_cache(cfg, 2, 48), backend="torch")
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    ssd_scan_cuda.launches = 0
    nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
    api.decode_step(params, nxt, cfg, cache)
    assert ssd_scan_cuda.launches == 0


# K5-bwd against its plain version and SSDScanFunction against autograd of
# the plain scan: each gradient's largest error over its largest magnitude
# (chip_smoke.py's K5BWD_RTOL; gA sums B x S terms with cancellation).  A
# gradient that is exactly zero (gA from h0 = 0 at S = 1) is held to
# SSD_BWD_ZERO, an absolute bound: a relative one would ask a kernel that
# sums the same terms in another order for exact zeros.
SSD_BWD_RTOL, SSD_BWD_ZERO = 1e-4, 1e-5
_GRAD_NAMES = ("gx", "gdt", "gA", "gBm", "gCm", "gh0")


def _assert_rel(got, want, rtol=SSD_BWD_RTOL):
    for name, g, w in zip(_GRAD_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert bool(torch.isfinite(g).all()), name
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        assert err <= (rtol * scale if scale > 0 else SSD_BWD_ZERO), (
            name, err, scale)


@pytest.mark.parametrize("b,s,h,p,n,with_h0,with_ghl", [
    (1, 1, 1, 4, 4, False, False), (2, 100, 3, 8, 16, True, True),
    (1, 320, 2, 64, 128, False, True), (2, 130, 3, 40, 20, True, False),
    (4, 1024, 24, 64, 128, False, False), (4, 1000, 24, 64, 128, True, True),
    (1, 64, 2, 16, 256, True, True),
    # P = 128: two blocks of 64 columns; N = 192: two blocks of 128 state
    # rows, the second ragged.
    (2, 130, 3, 128, 32, True, True), (1, 200, 2, 32, 192, True, True),
])
def test_ssd_scan_bwd_kernel_equals_plain(cuda_device, no_tf32, b, s, h, p,
                                          n, with_h0, with_ghl):
    from repro_torch.kernels.ssd_scan import (
        ssd_scan_bwd_cuda, ssd_scan_bwd_plain,
    )

    x, dt, A, Bm, Cm, h0 = _ssd_inputs(25, b, s, h, p, n, with_h0=with_h0)
    r = np.random.default_rng(26)
    gy = torch.as_tensor(r.standard_normal((b, s, h, p)), dtype=torch.float32,
                         device=cuda_device)
    ghl = (torch.as_tensor(r.standard_normal((b, h, n, p)),
                           dtype=torch.float32, device=cuda_device)
           if with_ghl else None)
    _, _, states = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=s, h0=h0,
                                 return_states=True)
    before = ssd_scan_bwd_cuda.launches
    got = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, states=states, chunk=s,
                            h0=h0, g_hlast=ghl)
    torch.cuda.synchronize()
    assert ssd_scan_bwd_cuda.launches == before + 1
    chunk = next(c for c in (64, 50, 10, s) if s % c == 0)
    want = ssd_scan_bwd_plain(x, dt, A, Bm, Cm, gy, chunk=chunk, h0=h0,
                              g_hlast=ghl)
    _assert_rel(got, want)
    again = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, states=states, chunk=s,
                              h0=h0, g_hlast=ghl)
    assert all(torch.equal(a, b_) for a, b_ in zip(got[:5], again[:5]))


def test_ssd_scan_function_gradients_on_the_card(cuda_device, no_tf32):
    """A grad-enabled scan on the card runs SSDScanFunction (K5, then
    K5-bwd) and its gradients equal autograd of the plain scan, at
    Mamba2-130M's init over 256-step chunks, all finite."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    x, _, _, Bm, Cm, _ = _ssd_inputs(27, 2, 512, 4, 64, 128)
    leaves = [x, torch.full((2, 512, 4), 0.69, device=cuda_device),
              -torch.ones(4, device=cuda_device), Bm, Cm]
    gy = torch.randn(x.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        ins = [t.clone().requires_grad_() for t in leaves]
        before = (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches)
        if use_kernel:
            y, _ = ops.ssd_scan(*ins, chunk=256)
            assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"
        else:
            y, _ = ssd_scan_plain(*ins, chunk=256)
        (y * gy).sum().backward()
        assert (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches) == (
            before[0] + use_kernel, before[1] + use_kernel)
        grads.append([t.grad for t in ins] + [None])
    _assert_rel(grads[0], grads[1])


def test_two_training_steps_on_the_card(cuda_device, no_tf32):
    """Two train steps of the fp32 smoke model on the card (K5 and K5-bwd
    once a layer each step) against the same steps on the CPU (the plain
    scan): loss, grad norm and parameters (each moves by at most lr =
    5e-4 a step; AdamW's g / (sqrt(nu) + eps) magnifies differences of
    gradients near eps, 1.2e-5 a step against the reference on the
    CPU)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data import make_stream
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    from repro_torch.train import init_state, make_optimizer, make_train_step

    cfg = dataclasses.replace(smoke_config("mamba2-130m"), dtype="float32")
    opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=10)
    stream = make_stream(cfg, batch=2, seq_len=64, seed=1)
    runs = {}
    for dev in ("cpu", cuda_device):
        state = init_state(torch.Generator().manual_seed(0), cfg, opt)
        state = {k: (v.to(dev) if isinstance(v, torch.Tensor) else
                     _to(v, dev)) for k, v in state.items()}
        step = make_train_step(cfg, opt)
        metrics = []
        for k in range(2):
            ssd_scan_cuda.launches = ssd_scan_bwd_cuda.launches = 0
            state, m = step(state, stream.batch_at(k))
            torch.cuda.synchronize()
            on_card = torch.device(dev).type == "cuda"
            assert ssd_scan_cuda.launches == cfg.num_layers * on_card
            assert ssd_scan_bwd_cuda.launches == cfg.num_layers * on_card
            metrics.append({k2: float(v) for k2, v in m.items()})
        runs[torch.device(dev).type] = (state, metrics)
    (cpu_state, cpu_m), (card_state, card_m) = runs["cpu"], runs["cuda"]
    for a, b in zip(cpu_m, card_m):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-3)
    for name, p in _flat(cpu_state["params"]).items():
        q = _flat(card_state["params"])[name].cpu()
        torch.testing.assert_close(q, p, atol=1e-4, rtol=0)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in
                _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the streaming runtime, tracker and service on the card
# ---------------------------------------------------------------------------
def _host_frames(n, h=480, w=640, seed=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


def _k1(frame, bins, device):
    from repro_torch.core.binning import bin_indices

    ids = bin_indices(torch.as_tensor(frame, device=device), bins)
    return wf_tis_cuda(ids.contiguous()[None], bins)[0]


def test_staged_buffers_are_pinned_and_copied_on_a_side_stream(cuda_device):
    from repro_torch.core.runtime import Stager

    frames = _host_frames(3, 64, 96)
    stager = Stager(cuda_device, 3)
    staged = [stager.stage(f) for f in frames]
    assert stager._stream != torch.cuda.current_stream(cuda_device)
    assert all(b.is_pinned() for b in stager.buffers)
    assert all(event is not None for _, event in staged)
    for f, s in zip(frames, staged):
        t = stager.ready(s)
        assert t.is_cuda and torch.equal(t.cpu(), torch.as_tensor(f))
    assert stager.copies == 3
    on_card = torch.zeros(4, 4, device=cuda_device)
    assert stager.stage(on_card)[0] is on_card          # not copied again


def test_ring_is_not_refilled_before_its_copy_completes(cuda_device):
    """A 2-deep ring under stage_ahead=2: every stage refills the buffer of
    the copy two before it, which must have landed first.  4 MB frames
    that all differ, so a refill racing its copy shows in what lands."""
    from repro_torch.core.runtime import FrameRuntime, Stager

    frames = _host_frames(8, 2048, 2048, seed=31)
    stager = Stager(cuda_device, 2)
    staged = [stager.stage(f) for f in frames]
    for f, s in zip(frames, staged):
        assert torch.equal(stager.ready(s).cpu(), torch.as_tensor(f))
    small = _host_frames(9, seed=32)
    rt = FrameRuntime(FrameRuntime.stateless(
        lambda x: ops.integral_histogram(x, 16)), depth=1, stage_ahead=2)
    outs = list(rt.map_frames(small))
    assert len(rt.last_stager.buffers) == 4
    for f, got in zip(small, outs):
        assert torch.equal(got, _k1(f, 16, cuda_device))


def test_map_frames_and_band_prefetch_equal_k1(cuda_device):
    from repro_torch.core.hsource import BandedH
    from repro_torch.core.integral_histogram import IntegralHistogram

    frames = _host_frames(6)
    for eng in (HistogramEngine(32), HistogramEngine(
            32, adaptive_microbatch=True)):
        before = wf_tis_cuda.launches
        outs = list(eng.map_frames(iter(frames), depth=2))
        stats = eng.last_runtime.last_stats
        assert wf_tis_cuda.launches - before == stats.dispatches
        assert all(b.is_pinned() for b in eng.last_runtime.last_stager
                   .buffers if b is not None)
        for f, got in zip(frames, outs):
            assert torch.equal(got, _k1(f, 32, cuda_device))
    big = _host_frames(1, 700, 900, seed=33)[0]
    ih = IntegralHistogram(num_bins=64)
    want = _k1(big, 64, cuda_device)
    rows = np.array([0, 99, 100, 350, 699])
    for prefetch in (0, 1, 2):
        got = BandedH(lambda: ih.map_bands(
            big, band_h=100, prefetch=prefetch)).rows(rows)
        assert torch.equal(got, want[:, torch.as_tensor(rows,
                                                        device=cuda_device)])


def test_tracker_paths_agree_on_the_card(cuda_device):
    from repro_torch.core.tracking import FragmentTracker, TrackerConfig
    from repro_torch.data import video_frames

    clip = video_frames(240, 320, 9, seed=3)
    cfg = TrackerConfig(num_bins=16, search_radius=6)
    tracker = FragmentTracker(cfg)
    plain = FragmentTracker(TrackerConfig(num_bins=16, search_radius=6,
                                          backend="torch"))
    cpu = FragmentTracker(cfg, device="cpu")
    for box in ([60, 80, 107, 143], [[60, 80, 107, 143], [20, 200, 83, 271]]):
        st = tracker.init(clip[0], box)
        _, boxes = tracker.track(dict(st), clip[1:])
        _, want = plain.track(plain.init(clip[0], box), clip[1:])
        _, on_cpu = cpu.track(cpu.init(clip[0], box), clip[1:])
        assert torch.equal(boxes, want) and torch.equal(boxes.cpu(), on_cpu)
        _, inc = tracker.track(dict(st), list(clip[1:]), incremental=True)
        assert torch.equal(inc, boxes)
        s1 = dict(st)
        for f, b in zip(clip[1:], boxes):
            s1 = tracker.step_fused(s1, f)
            assert torch.equal(s1["bbox"], b)


def test_service_answers_equal_engine_run(cuda_device):
    from repro_torch.serve import AnalyticsService

    frames = dict(enumerate(_host_frames(4, 240, 320, seed=34)))
    queries = [RegionQuery(np.array([[10, 20, 99, 149]])),
               LikelihoodQuery(np.ones(32, np.float32), (32, 32), stride=8),
               SlidingWindowQuery((16, 16), 4)]
    with AnalyticsService(HistogramEngine(32), frames) as svc:
        futs = [svc.submit(ref, q, block=True) for ref in (0, 1, 0, 2, 3)
                for q in queries]
        got = [f.result(timeout=120) for f in futs]
    for i, ref in enumerate((0, 1, 0, 2, 3)):
        want = HistogramEngine(32).run(frames[ref], queries).results
        for g, w in zip(got[3 * i:3 * i + 3], want):
            assert torch.equal(g, w)
    snap = svc.stats.snapshot()
    assert snap["completed"] == 15 and snap["latency_p95_s"] > 0


def test_bin_sum_and_metrics_equal_the_cpu(cuda_device):
    from repro_torch.core import distances

    g = torch.Generator(device=cuda_device).manual_seed(3)
    for bins in (8, 32, 64):
        planes = torch.rand((3, bins, 17, 29), device=cuda_device,
                            generator=g)
        for x in (planes.movedim(1, -1), planes[0, :, 0, 0],
                  planes[:1, :, :1, 0]):
            assert torch.equal(distances.bin_sum(x).cpu(),
                               distances.bin_sum(x.cpu()))
        a, t = planes.movedim(1, -1) * 40, planes[1, :, 2, 5]
        for metric in (*distances.SIMILARITIES.values(),
                       *distances.DISTANCES.values()):
            assert torch.equal(metric(a, t).cpu(), metric(a.cpu(), t.cpu()))


def _card_mesh(device, rows, cols):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh((rows, cols), devices=[device] * (rows * cols))


@pytest.mark.parametrize("sharding,budget", [
    ("bin", None), ("spatial", None), ("bin", 8 << 20), ("spatial", 8 << 20),
])
def test_sharded_engine_on_logical_shards_equals_k1(cuda_device, sharding,
                                                    budget):
    """A mesh that lists the card 4 times: bin- and spatially sharded H,
    banded or not, equal one dense K1 launch bit for bit, K1 once a
    shard a band."""
    frame = _host_frames(1, 272, 640, seed=41)[0]
    want = _k1(frame, 64, cuda_device)
    mesh = (_card_mesh(cuda_device, 1, 4) if sharding == "bin"
            else _card_mesh(cuda_device, 4, 1))
    eng = HistogramEngine(64, mesh=mesh, sharding=sharding,
                          memory_budget_bytes=budget)
    rects = np.array([[0, 0, 271, 639], [60, 7, 200, 500]])
    before = wf_tis_cuda.launches
    out = eng.run(frame, [RegionQuery(rects)])
    bp = out.plan.band_plan
    assert out.plan.sharding == sharding
    assert wf_tis_cuda.launches - before == 4 * (1 if bp is None
                                                  else bp.num_bands)
    assert torch.equal(out.source.dense(), want)
    from repro_torch.core import region_query as rq

    assert torch.equal(out.results[0], rq.region_histogram(want, rects))


def test_exclusive_axis_scans_agree_on_the_card(cuda_device):
    from repro_torch.core import distributed

    rng = np.random.default_rng(42)
    xs = rng.integers(0, 1 << 20, (5, 32, 640)).astype(np.float32)
    want = np.cumsum(xs, axis=0) - xs
    ts = [torch.as_tensor(x, device=cuda_device) for x in xs]
    for impl in ("allgather", "ppermute"):
        got = distributed.exclusive_axis_scan(ts, impl)
        for g, w in zip(got, want):
            assert np.array_equal(g.cpu().numpy(), w)


def test_distributed_service_on_logical_shards(cuda_device):
    from repro_torch.serve import (
        AnalyticsService,
        DistributedAnalyticsService,
        sharded_engine_factory,
    )

    frames = dict(enumerate(_host_frames(4, 128, 192, seed=43)))
    queries = [RegionQuery(np.array([[3 * i, 2, 3 * i + 1, 90]
                                     for i in range(20)])),
               SlidingWindowQuery((16, 16), 8)]
    trace = [(r, q) for r in (0, 1, 2, 1, 3) for q in queries]
    want = AnalyticsService(HistogramEngine(32), frames).process(trace)
    for kw in (dict(mesh=_card_mesh(cuda_device, 2, 2)),
               dict(num_replicas=4)):
        svc = DistributedAnalyticsService(sharded_engine_factory(32),
                                          frames, **kw)
        for g, w in zip(svc.process(trace), want):
            assert torch.equal(g, w)
        assert svc.snapshot()["engine_runs"] == 4


# The decoder transformer (dense, moe, vlm) runs no kernel of ours: the
# smoke configs on the card against the same model on the CPU, as
# chip_smoke's transformer phase (a) holds them (its TF_CARD_ATOL), and the
# MoE block against its plain per-expert loop, as its phase (c) does.
TF_CARD_ATOL = 1e-4
_TF_ARCHS = ("qwen2-1.5b", "qwen2.5-3b", "qwen3-4b", "llama3-8b",
             "llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
             "llava-next-mistral-7b")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", _TF_ARCHS)
def test_transformer_on_the_card_equals_the_cpu(cuda_device, no_tf32, arch):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import api

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    cpu_model = api.init_params(torch.Generator().manual_seed(0), cfg)
    models = {"cpu": cpu_model, "cuda": api.model_over(
        _to(api.stacked_params(cpu_model), cuda_device), cfg)}
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, (2, 74)).astype(np.int32)
    prefix = (rng.standard_normal((2, cfg.num_prefix_embeds, cfg.d_model))
              * 0.02).astype(np.float32)
    out = {}
    for where, model in models.items():
        t = torch.as_tensor(toks, device=where)
        batch = {"tokens": t[:, :70]}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.as_tensor(prefix, device=where)
        cache = api.init_cache(cfg, 2, cfg.num_prefix_embeds + 74,
                               dtype=torch.float32, device=where)
        ssd_scan_cuda.launches = 0
        if where == "cuda":           # no step waits for the card
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, cache = api.prefill(model, batch, cfg, cache)
            steps = [lg]
            for i in range(70, 74):
                lg, cache = api.decode_step(model, t[:, i:i + 1], cfg, cache)
                steps.append(lg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ssd_scan_cuda.launches == 0
        out[where] = torch.stack(steps, 1).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=TF_CARD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_griffin_and_encdec_on_the_card_equal_the_cpu(cuda_device, no_tf32,
                                                      arch):
    """Griffin's and the encoder-decoder's smoke configs in fp32: a
    70-token prefill (past Griffin's 32-slot ring; 70 source frames) and
    4 decode steps on the card, none waiting for it on the host, against
    the CPU."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import api

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    cpu_model = api.init_params(torch.Generator().manual_seed(0), cfg)
    models = {"cpu": cpu_model, "cuda": api.model_over(
        _to(api.stacked_params(cpu_model), cuda_device), cfg)}
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab_size, (2, 74)).astype(np.int32)
    src = (rng.standard_normal((2, 70, cfg.d_model)) * 0.02).astype(
        np.float32)
    audio = cfg.family == "audio"
    out = {}
    for where, model in models.items():
        t = torch.as_tensor(toks, device=where)
        batch = {"tokens": t[:, :70]}
        if audio:
            batch["src_embeds"] = torch.as_tensor(src, device=where)
        cache = api.init_cache(cfg, 2, 74, dtype=torch.float32, device=where,
                               src_len=70 if audio else None)
        if where == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, cache = api.prefill(model, batch, cfg, cache)
            steps = [lg]
            for i in range(70, 74):
                lg, cache = api.decode_step(model, t[:, i:i + 1], cfg, cache)
                steps.append(lg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[where] = torch.stack(steps, 1).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=TF_CARD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama4-scout-17b-a16e",
                                  "llava-next-mistral-7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_train_step_on_the_card_equals_the_cpu(cuda_device, no_tf32, arch):
    """One train step (AdamW) of each family's smoke config in fp32 from
    the same seed-0 state: loss and grad norm within 1e-5 of the CPU's
    (relative), every parameter within 5e-5 where its gradient is not
    within a few AdamW eps of 0 (tests/_lm_parity.py)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data import make_stream
    from repro_torch.train import init_state, make_optimizer, make_train_step

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    opt = make_optimizer(cfg, peak_lr=1e-3, warmup=2, total_steps=40)
    cpu_state = init_state(torch.Generator().manual_seed(0), cfg, opt)
    card_state = _to(cpu_state, cuda_device)
    batch = make_stream(cfg, 2, 64, 0).batch_at(0)
    step = make_train_step(cfg, opt)
    cpu_new, cpu_m = step(cpu_state, batch)
    card_new, card_m = step(card_state, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(card_m[k]) - float(cpu_m[k])) <= 1e-5 * abs(
            float(cpu_m[k])), k

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k in tree for p, v in leaves(
                tree[k], f"{prefix}/{k}").items()}
        return {prefix: tree.cpu()}

    got, want = leaves(card_new["params"]), leaves(cpu_new["params"])
    mu = leaves(cpu_new["opt"]["mu"])
    for key, w in want.items():
        away = mu[key].abs() >= 1e-7
        assert float(((got[key] - w).abs() * away).max()) <= 5e-5, key


@pytest.mark.parametrize("k,capacity_factor", [(1, 0.25), (2, 0.5),
                                               (2, 3.0)])
def test_moe_block_on_the_card_equals_its_plain_version(cuda_device, no_tf32,
                                                        k, capacity_factor):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        smoke_config("kimi-k2-1t-a32b"), dtype="float32",
        num_experts_per_token=k, capacity_factor=capacity_factor)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    p = moe.moe_params(gen, cfg)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = moe.moe_block(x, p, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, dropped = moe.moe_block_plain(x, p, cfg)
    assert (dropped > 0) == (capacity_factor < 1)
    torch.testing.assert_close(got, want, atol=1e-5 * float(
        want.abs().max()), rtol=0)


@pytest.mark.parametrize("rows,cols", [(1, 4), (2, 2)])
def test_ssd_seq_parallel_on_logical_shards(cuda_device, no_tf32, rows, cols):
    """ssd_seq_parallel on a mesh that lists the card 4 times, at
    Mamba2-130M's prefill shape (B=4, S=1024, H=24, P=64, N=128) from a
    random h0: K5 once a shard forward and K5-bwd once a shard backward
    (h_last's gradient reaching every shard but the last through the
    ladder); y, the final state and the six gradients against the same
    mesh with the plain scan (within SSD_ATOL/RTOL, SSD_BWD_RTOL), and
    against the unsharded K5 and K5-bwd."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    from repro_torch.models.ssm import ssd_chunked, ssd_seq_parallel
    from repro_torch.sharding import ShardingRules

    mesh = _card_mesh(cuda_device, rows, cols)
    leaves = _ssd_inputs(29, 4, 1024, 24, 64, 128, with_h0=True)
    r = np.random.default_rng(30)
    gy = torch.as_tensor(r.standard_normal((4, 1024, 24, 64)),
                         dtype=torch.float32, device=cuda_device)
    ghl = torch.as_tensor(r.standard_normal((4, 24, 128, 64)),
                          dtype=torch.float32, device=cuda_device)
    runs = {}
    for name in ("kernel", "plain", "unsharded"):
        ins = [t.clone().requires_grad_() for t in leaves]
        x, dt, A, Bm, Cm, h0 = ins
        before = (ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches)
        if name == "unsharded":
            y, hl = ssd_chunked(x, dt, A, Bm, Cm, 256, h0=h0)
        else:
            y, hl = ssd_seq_parallel(
                x, dt, A, Bm, Cm, 256, mesh, ShardingRules(), h0=h0,
                backend="cuda" if name == "kernel" else "torch")
        ((y * gy).sum() + (hl * ghl).sum()).backward()
        torch.cuda.synchronize()
        shards = rows * cols if name == "kernel" else (name == "unsharded")
        assert (ssd_scan_cuda.launches - before[0],
                ssd_scan_bwd_cuda.launches - before[1]) == (shards, shards)
        runs[name] = [y.detach(), hl.detach()] + [t.grad for t in ins]
    for other in ("plain", "unsharded"):
        for got, want in zip(runs["kernel"][:2], runs[other][:2]):
            torch.testing.assert_close(got, want, atol=SSD_ATOL,
                                       rtol=SSD_RTOL)
        _assert_rel(runs["kernel"][2:], runs[other][2:])


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
def test_expert_parallel_moe_on_the_card_equals_the_cpu(cuda_device, no_tf32,
                                                        capacity_factor):
    """moe_block under a sharding context on a 2 x 2 mesh of the card
    (experts over the model axis, tokens over data) against the same mesh
    of CPU entries, with and without a binding capacity."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import sharding_context

    cfg = dataclasses.replace(smoke_config("kimi-k2-1t-a32b"),
                              dtype="float32",
                              capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(4)
    p = moe.moe_params(gen, cfg)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        with sharding_context(make_host_mesh((2, 2), devices=[dev] * 4)):
            out, aux = moe.moe_block(x.to(dev), {k: v.to(dev)
                                                 for k, v in p.items()}, cfg)
        assert out.device.type == dev.type
        outs.append((out.cpu(), float(aux)))
    (got, aux_got), (want, aux_want) = outs
    torch.testing.assert_close(got, want, atol=1e-5 * float(
        want.abs().max()), rtol=0)
    assert abs(aux_got - aux_want) <= 1e-5 * abs(aux_want)
