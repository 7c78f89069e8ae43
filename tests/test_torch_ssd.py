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
    smem_bytes,
    ssd_scan_cuda,
    ssd_scan_plain,
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
    # The model's geometry fits one CTA; the TPU's whole 256-step blocks
    # would not.
    assert smem_bytes(64, 128) <= 227 * 1024
    with pytest.raises(NotImplementedError, match="shared memory"):
        x = torch.zeros((1, 16, 1, 256))
        B = torch.zeros((1, 16, 1, 256))
        ssd_scan_cuda(x, torch.zeros((1, 16, 1)), torch.zeros(1), B, B,
                      chunk=16)


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
