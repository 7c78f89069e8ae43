"""repro_torch's SSD scan (K5's plain version and ops.ssd_scan) held
against the JAX reference.

The same inputs, made from a numpy seed, go through
``repro.kernels.ssd_scan.ssd_scan`` (the Pallas kernel with
``interpret=True``) or ``repro.models.ssm.ssd_chunked`` on the CPU, and
through the port with CPU tensors, where ``ops.ssd_scan`` runs
``ssd_scan_plain``.  fp32 throughout; the tolerance of each comparison is
stated beside it with the largest error measured here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (
    KERNEL_CHUNK,
    scan_smem_bytes,
    smem_bytes,
    ssd_scan_cuda,
    ssd_scan_plain,
    state_smem_bytes,
)
from repro_torch.models.ssm import ssd_chunked

torch.set_num_threads(1)

# Against the Pallas kernel, as tests/test_kernels.py holds it against its
# oracle; the largest error measured here was 2.7e-6.
ATOL_KERNEL = 1e-4
# Against ssd_chunked at another or the same chunk length: fp32 rounding
# of the chunk loop in another order; largest measured 1.0e-6.
ATOL, RTOL = 1e-5, 1e-5


def _inputs(seed, b=2, s=64, h=3, p=8, n=16, g=1, with_h0=False):
    """numpy inputs in the ranges the model gives the scan."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(r.standard_normal(h) * 0.2)).astype(np.float32)
    Bm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    h0 = (r.standard_normal((b, h, n, p)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


def _t(arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("fn", ["plain", "ops"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_scan_matches_pallas_kernel(chunk, fn):
    arrays = _inputs(3)
    x, dt, A, Bm, Cm, _ = arrays
    want = np.asarray(ref_ssd_scan(*_j(arrays[:5]), chunk=chunk,
                                   interpret=True))
    tx, tdt, tA, tB, tC, _ = _t(arrays)
    if fn == "plain":
        y, _ = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=chunk)
    else:
        y, _ = ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk,
                            backend="torch")
    np.testing.assert_allclose(y.numpy(), want, atol=ATOL_KERNEL, rtol=0)


@pytest.mark.parametrize("s,chunk,with_h0", [
    (64, 16, False), (64, 16, True), (50, 16, False), (50, 16, True),
    (37, 8, True),
])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """y and h_last, with and without h0, on ragged S (padding path)."""
    arrays = _inputs(4, s=s, with_h0=with_h0)
    x, dt, A, Bm, Cm, h0 = arrays
    y_ref, h_ref = ref_ssd_chunked(*_j(arrays[:5]), chunk=chunk,
                                   h0=None if h0 is None else jnp.asarray(h0))
    y, h_last = ssd_chunked(*_t(arrays[:5]), chunk,
                            h0=None if h0 is None else torch.as_tensor(h0))
    assert tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_ref), atol=ATOL,
                               rtol=RTOL)


def test_ssd_scan_plain_groups_match_reference():
    """The plain version runs G > 1 (the CPU path), as ssd_chunked does."""
    arrays = _inputs(5, h=4, g=2, with_h0=True)
    y_ref, h_ref = ref_ssd_chunked(*_j(arrays[:5]), chunk=16,
                                   h0=jnp.asarray(arrays[5]))
    y, h_last = ssd_scan_plain(*_t(arrays[:5]), chunk=16,
                               h0=torch.as_tensor(arrays[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_ref), atol=ATOL,
                               rtol=RTOL)


def test_ssd_chunked_state_carries_between_calls():
    """Scanning S in two halves, the second seeded with the first's
    h_last, equals one scan of S (what prefill into a state relies on)."""
    tx, tdt, tA, tB, tC, _ = _t(_inputs(6, s=48))
    y, h = ssd_chunked(tx, tdt, tA, tB, tC, 16)
    y1, h1 = ssd_chunked(tx[:, :20], tdt[:, :20], tA, tB[:, :20],
                         tC[:, :20], 16)
    y2, h2 = ssd_chunked(tx[:, 20:], tdt[:, 20:], tA, tB[:, 20:],
                         tC[:, 20:], 16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(h2, h, atol=ATOL, rtol=RTOL)


def test_cuda_backend_on_cpu_tensor_raises():
    tx, tdt, tA, tB, tC, _ = _t(_inputs(7))
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=16, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.ssd_scan(tx, tdt, tA, tB, tC, chunk=16, backend="pallas")


def test_kernel_path_refuses_groups_and_odd_widths():
    """The kernel's contract is checked whatever the device: G > 1 (the
    reference kernel takes Bm[:, :, 0]) and widths not a multiple of 4."""
    tx, tdt, tA, tB, tC, _ = _t(_inputs(8, h=4, g=2))
    with pytest.raises(NotImplementedError, match="G=2"):
        ssd_scan_cuda(tx, tdt, tA, tB, tC, chunk=16)
    tx, tdt, tA, tB, tC, _ = _t(_inputs(8, p=6))
    with pytest.raises(NotImplementedError, match="multiples of 4"):
        ssd_scan_cuda(tx, tdt, tA, tB, tC, chunk=16)
    # On a CPU tensor the wrapper runs the plain version.
    tx, tdt, tA, tB, tC, _ = _t(_inputs(8))
    before = ssd_scan_cuda.launches
    y, h = ssd_scan_cuda(tx, tdt, tA, tB, tC, chunk=16)
    want = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=16)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert ssd_scan_cuda.launches == before


def test_kernel_layout_and_shared_memory_limits():
    tx, tdt, tA, tB, tC, _ = _t(_inputs(9, p=8))
    with pytest.raises(ValueError, match="inner dims dense"):
        ssd_scan_cuda(tx.transpose(2, 3).contiguous().transpose(2, 3),
                      tdt, tA, tB, tC, chunk=16)
    # The chunk scan's CTA at the model's geometry: C, B (a head's
    # entering state later in its place), xdt and the masked scores of one
    # 64-step chunk and 64 columns of P, padded; two CTAs fit an SM's
    # 228 KiB.  The state scan's CTA holds three chunks' copies in flight.
    assert scan_smem_bytes(128) == 4 * (64 * 132 + 128 * 72 + 64 * 72
                                        + 64 * 68 + 2 * 64)
    assert 2 * (scan_smem_bytes(128) + 1024) <= 228 * 1024
    assert state_smem_bytes() == 4 * (3 * (64 * 136 + 64 * 72 + 64) + 68)
    assert smem_bytes(64, 128) == state_smem_bytes() <= 227 * 1024
    # P is split into blocks of 64 columns, so only N grows a CTA.
    assert smem_bytes(256, 128) == smem_bytes(64, 128)
    assert smem_bytes(64, 256) <= 227 * 1024
    with pytest.raises(NotImplementedError, match="shared memory"):
        x = torch.zeros((1, 16, 1, 64))
        B = torch.zeros((1, 16, 1, 512))
        ssd_scan_cuda(x, torch.zeros((1, 16, 1)), torch.zeros(1), B, B,
                      chunk=16)


# K5's design, restated in plain torch: the chunk-parallel SSD form the
# kernel computes (each chunk's own state, the state passing, each
# chunk's outputs), with its four products done the way the tensor cores
# do them.  TF32 keeps 10 explicit mantissa bits.  The kernel's split,
# by bit masks: hi = x rounded to TF32 (a half-ulp add, then the low 13
# bits cleared), lo = x - hi with its low 13 bits cleared.
def _tf32_round(t):
    return ((t.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _tf32_trunc(t):
    return (t.view(torch.int32) & -8192).view(torch.float32)


def _mm_fp32(a, b):
    return a @ b


def _mm_tf32(a, b):
    return _tf32_round(a) @ _tf32_round(b)


def _mm_3xtf32(a, b):
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


_PRODUCTS = {"fp32": _mm_fp32, "tf32": _mm_tf32, "3xtf32": _mm_3xtf32}


def _chunk_parallel_scan(x, dt, A, Bm, Cm, h0, mm, q=KERNEL_CHUNK):
    """y, h_last of the kernel's three steps; S is padded to whole chunks
    with identity steps (dt = 0), as the kernel masks its last chunk."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = -s % q
    if pad:
        x, dt, Bm, Cm = (torch.nn.functional.pad(
            t, (0,) * (2 * (t.ndim - 2)) + (0, pad)) for t in (x, dt, Bm, Cm))
    c = (s + pad) // q
    xc = x.reshape(b, c, q, h, p).permute(0, 3, 1, 2, 4)      # b h c q p
    dtc = dt.reshape(b, c, q, h).permute(0, 3, 1, 2)         # b h c q
    Bc = Bm[:, :, 0].reshape(b, 1, c, q, n)
    Cc = Cm[:, :, 0].reshape(b, 1, c, q, n)
    acum = torch.cumsum(dtc * A[None, :, None, None], -1)
    total = acum[..., -1]
    # 1. each chunk's own contribution to the state it leaves
    X = xc * (dtc * torch.exp(total[..., None] - acum))[..., None]
    S = mm(Bc.transpose(-1, -2), X)                          # b h c n p
    # 2. the state entering each chunk
    hs = torch.zeros((b, h, n, p)) if h0 is None else h0
    enter = []
    for k in range(c):
        enter.append(hs)
        hs = torch.exp(total[..., k])[..., None, None] * hs + S[:, :, k]
    # 3. each chunk's outputs
    y = mm(Cc, torch.stack(enter, 2)) * torch.exp(acum)[..., None]
    L = torch.where(torch.tril(torch.ones(q, q, dtype=torch.bool)),
                    torch.exp(acum[..., :, None] - acum[..., None, :]), 0.0)
    y = y + mm(mm(Cc, Bc.transpose(-1, -2)) * L, xc * dtc[..., None])
    return y.permute(0, 2, 3, 1, 4).reshape(b, s + pad, h, p)[:, :s], hs


def _recurrence_fp64(x, dt, A, Bm, Cm):
    """The scan step by step in fp64, from h = 0."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    b, s, h, p = x.shape
    hs = torch.zeros((b, h, Bm.shape[-1], p), dtype=torch.float64)
    ys = []
    for t in range(s):
        hs = (torch.exp(dt[:, t] * A)[..., None, None] * hs
              + Bm[:, t, 0][:, None, :, None]
              * (x[:, t] * dt[:, t, :, None])[:, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t, 0], hs))
    return torch.stack(ys, 1), hs


@pytest.mark.parametrize("s,with_h0", [(64, False), (65, True),
                                       (200, True), (37, False)])
def test_kernel_decomposition_equals_plain(s, with_h0):
    """The chunk-parallel form (fp32 products) equals the plain chunk loop
    up to rounding, h0 and ragged S included."""
    arrays = _inputs(12, s=s, h=3, p=8, n=16, with_h0=with_h0)
    tx, tdt, tA, tB, tC, th0 = _t(arrays)
    chunk = {64: 16, 65: 5, 200: 25, 37: 37}[s]
    y, h_last = _chunk_parallel_scan(tx, tdt, tA, tB, tC, th0, _mm_fp32)
    y_want, h_want = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk=chunk, h0=th0)
    torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(h_last, h_want, atol=ATOL, rtol=RTOL)


# K5's gate on the card (chip_smoke.py's K5_ATOL, K5_RTOL).
K5_ATOL, K5_RTOL = 1e-4, 1e-4


@pytest.mark.parametrize("products,within_gate", [
    ("fp32", True), ("3xtf32", True), ("tf32", False)])
def test_3xtf32_products_keep_the_gate_plain_tf32_does_not(products,
                                                           within_gate):
    """Why K5 splits each operand: at 1x1024x6x64, N = 128, with the
    model's input ranges, the chunk-parallel scan with 3xTF32 products
    stays within K5's gate of an fp64 scan (as fp32 products do; largest
    error 2.3e-5 here), while plain TF32 products leave 56% of y outside
    it (largest error 9.8e-3)."""
    r = np.random.default_rng(9)
    b, s, h, p, n = 1, 1024, 6, 64, 128
    arrays = (r.standard_normal((b, s, h, p)),
              np.log1p(np.exp(r.standard_normal((b, s, h)))),
              -np.exp(r.standard_normal(h) * 0.2),
              r.standard_normal((b, s, 1, n)) * 0.3,
              r.standard_normal((b, s, 1, n)) * 0.3)
    tx, tdt, tA, tB, tC = (torch.as_tensor(a, dtype=torch.float32)
                           for a in arrays)
    y64, h64 = _recurrence_fp64(tx, tdt, tA, tB, tC)
    y, h_last = _chunk_parallel_scan(tx, tdt, tA, tB, tC, None,
                                     _PRODUCTS[products])
    outside = (y.double() - y64).abs() > K5_ATOL + K5_RTOL * y64.abs()
    if within_gate:
        assert not bool(outside.any()), float(outside.double().mean())
        assert torch.allclose(h_last.double(), h64, atol=K5_ATOL,
                              rtol=K5_RTOL)
    else:
        assert float(outside.double().mean()) > 0.4


@pytest.mark.parametrize("bad", [
    "ragged_s", "dtype", "dt_shape", "A_shape", "groups", "h0_shape",
    "bc_mismatch",
])
def test_bad_inputs_raise(bad):
    x, dt, A, Bm, Cm, h0 = _t(_inputs(10, s=32, with_h0=True))
    chunk = 16
    if bad == "ragged_s":
        chunk = 10
    elif bad == "dtype":
        x = x.double()
    elif bad == "dt_shape":
        dt = dt[:, :, :2]
    elif bad == "A_shape":
        A = A[:2]
    elif bad == "groups":
        Bm = Cm = torch.zeros((2, 32, 2, 16))    # 2 groups, 3 heads
    elif bad == "h0_shape":
        h0 = h0[..., :4]
    elif bad == "bc_mismatch":
        Cm = Cm[..., :8]
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)


def test_segsum_decay_matches_reference():
    from repro.models.ssm import _segsum_decay as ref_segsum
    from repro_torch.models.ssm import _segsum_decay

    a_cum = np.cumsum(-np.random.default_rng(11).random((2, 3, 16)),
                      axis=-1).astype(np.float32)
    np.testing.assert_allclose(
        _segsum_decay(torch.as_tensor(a_cum)).numpy(),
        np.asarray(ref_segsum(jnp.asarray(a_cum))), atol=1e-7, rtol=1e-6)


def test_scan_backend_rule_does_not_depend_on_histogram_methods(monkeypatch):
    """ops.ssd_scan takes the backend/device rule alone: "auto" picks K5
    for a CUDA tensor whatever the histogram scans' CUDA methods are."""
    card = torch.device("cuda")
    monkeypatch.setattr(ops, "CUDA_METHODS", ())
    assert ops.kernel_backend("auto", card) == "cuda"
    assert ops.kernel_backend("cuda", card) == "cuda"
    assert ops.kernel_backend("torch", card) == "torch"
    assert ops.kernel_backend("auto", torch.device("cpu")) == "torch"
    with pytest.raises(ValueError, match="backend='cuda'"):
        ops.kernel_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.kernel_backend("pallas", card)
