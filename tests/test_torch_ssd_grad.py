"""The SSD scan's gradients in repro_torch (K5-bwd's plain version, the
kernel's algorithm, SSDScanFunction's routing) held against autograd and
against ``jax.grad`` of the JAX reference.

The same inputs, made from a numpy seed, go through
``repro.models.ssm.ssd_chunked`` under ``jax.grad`` and through the port
with CPU tensors.  A CUDA kernel cannot run here: its algorithm is
restated in torch below (as tests/test_torch_ssd.py restates K5's) and
held against the plain version, and the autograd routing on the card is
held by handing the wrappers tensors that report ``is_cuda`` and putting
Python stand-ins in place of the two C functions (``_lib``,
``_bwd_lib``), which compute from the pointers they are given.  fp32
throughout; each tolerance is stated with the largest error measured.
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels.ssd_scan import (
    BWD_COLUMNS,
    KERNEL_CHUNK,
    bwd_smem_bytes,
    segsum_decay,
    ssd_scan_bwd_cuda,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
)

torch.set_num_threads(1)

NAMES = ("x", "dt", "A", "Bm", "Cm", "h0")
# Gradients against autograd of the plain scan and against jax.grad of
# the reference: fp32 sums in another order, relative to each gradient's
# largest magnitude.  Largest measured 4.0e-5 for gA (a sum over B and S
# with cancellation; autograd at chunk 256 against the reference at 64),
# 5.1e-6 for every other gradient.
GRAD_RTOL = 1e-4
# The kernel's algorithm (and the routed Function) against the plain
# version: the per-step walk and the q identity for ga sum in another
# order.  Largest measured 1.8e-5 for gA, 3.5e-6 elsewhere.
DESIGN_RTOL = 1e-4


def _inputs(seed, b=2, s=64, h=3, p=8, n=16, g=1, with_h0=False,
            const_dt=None):
    """numpy inputs in the ranges the model gives the scan, and the
    gradients gy of y and g_hlast of the last state."""
    r = np.random.default_rng(seed)
    dt = (np.full((b, s, h), const_dt) if const_dt is not None
          else np.log1p(np.exp(r.standard_normal((b, s, h)))))
    A = (-np.ones(h) if const_dt is not None
         else -np.exp(r.standard_normal(h) * 0.2))
    arrays = {
        "x": r.standard_normal((b, s, h, p)), "dt": dt, "A": A,
        "Bm": r.standard_normal((b, s, g, n)) * 0.3,
        "Cm": r.standard_normal((b, s, g, n)) * 0.3,
        "h0": r.standard_normal((b, h, n, p)) if with_h0 else None,
        "gy": r.standard_normal((b, s, h, p)),
        "g_hlast": r.standard_normal((b, h, n, p)),
    }
    return {k: None if v is None else v.astype(np.float32)
            for k, v in arrays.items()}


def _t(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


def _ref_grads(a, chunk):
    """jax.grad of <y, gy> + <h_last, g_hlast> through ssd_chunked."""
    names = [k for k in NAMES if a[k] is not None]

    def loss(*args):
        kw = dict(zip(names, args))
        y, h_last = ref_ssd_chunked(kw["x"], kw["dt"], kw["A"], kw["Bm"],
                                    kw["Cm"], chunk, h0=kw.get("h0"))
        return jnp.sum(y * a["gy"]) + jnp.sum(h_last * a["g_hlast"])

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[k]) for k in names))
    out = dict(zip(names, (np.asarray(g) for g in grads)))
    return [out.get(k) for k in NAMES]


def _autograd_grads(a, chunk):
    """Autograd of the same loss through ssd_scan_plain."""
    t = {k: _t(a[k], grad=True) for k in NAMES}
    y, h_last = ssd_scan_plain(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                               chunk=chunk, h0=t["h0"])
    (torch.sum(y * _t(a["gy"])) + torch.sum(h_last * _t(a["g_hlast"]))
     ).backward()
    return [None if t[k] is None else t[k].grad.numpy() for k in NAMES]


def _plain_bwd(a, chunk):
    t = {k: _t(a[k]) for k in NAMES}
    out = ssd_scan_bwd_plain(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             _t(a["gy"]), chunk=chunk, h0=t["h0"],
                             g_hlast=_t(a["g_hlast"]))
    return [None if g is None else g.numpy() for g in out]


def _assert_grads(got, want, rtol):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert np.all(np.isfinite(g)), name
        err = np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30)
        assert err <= rtol, (name, err)


# --------------------------------------------------------------------------
# the plain backward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 3])
def test_plain_bwd_matches_autograd_and_reference(chunk, with_h0, groups):
    a = _inputs(30 + chunk + groups, s=128, h=3, g=groups, with_h0=with_h0)
    got = _plain_bwd(a, chunk)
    _assert_grads(got, _autograd_grads(a, chunk), GRAD_RTOL)
    _assert_grads(got, _ref_grads(a, chunk), GRAD_RTOL)


def test_plain_bwd_without_gradient_of_the_last_state():
    a = _inputs(41, s=48, with_h0=True)
    t = {k: _t(a[k]) for k in NAMES}
    got = ssd_scan_bwd_plain(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             _t(a["gy"]), chunk=16, h0=t["h0"])
    a["g_hlast"] = np.zeros_like(a["g_hlast"])
    _assert_grads([g.numpy() for g in got], _autograd_grads(a, 16),
                  GRAD_RTOL)


def test_chunk_256_gradient_is_finite_where_the_reference_is_nan():
    """At Mamba2-130M's chunk of 256 steps with its init (dt = 0.69,
    A = -1) the summed decay between two steps of one chunk passes 88:
    the reference's gradient through ssd_chunked is NaN (its decay mask
    takes ``where`` of an overflowing ``exp``).  The port's, masked before
    the ``exp``, is finite and equals the reference's at chunk 64, where
    the reference is finite (the scan does not depend on the chunk)."""
    a = _inputs(42, b=1, s=256, h=2, p=8, n=16, const_dt=0.69)
    ref256 = _ref_grads(a, 256)
    assert np.isnan(ref256[1]).any() and np.isnan(ref256[2]).any()
    ref64 = _ref_grads(a, 64)
    assert all(np.all(np.isfinite(g)) for g in ref64 if g is not None)
    _assert_grads(_autograd_grads(a, 256), ref64, GRAD_RTOL)
    _assert_grads(_plain_bwd(a, 256), ref64, GRAD_RTOL)


def test_segsum_decay_values_unchanged_and_gradient_finite():
    """Masked before the exp, the decay matrix is the unmasked form's bit
    for bit, and its gradient stays finite where exp(diff) overflows."""
    r = np.random.default_rng(43)
    a_cum = torch.tensor(np.cumsum(-r.random((2, 3, 256)) * 1.4, -1),
                         dtype=torch.float32, requires_grad=True)
    got = segsum_decay(a_cum)
    q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    unmasked = torch.where(tri, torch.exp(diff), 0.0)
    assert torch.equal(got, unmasked)
    assert bool(torch.isinf(torch.exp(diff)).any())
    got.sum().backward()
    assert bool(torch.isfinite(a_cum.grad).all())


# --------------------------------------------------------------------------
# K5-bwd's algorithm, restated in torch
# --------------------------------------------------------------------------
def _entry_states(x, dt, A, Bm, Cm, h0, q=KERNEL_CHUNK):
    """The state entering each q-step chunk, as K5 writes it."""
    b, s, h, p = x.shape
    hs = torch.zeros((b, h, Bm.shape[-1], p)) if h0 is None else h0
    out = []
    for c0 in range(0, s, q):
        out.append(hs)
        sl = slice(c0, c0 + q)
        _, hs = ssd_scan_plain(x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl],
                               chunk=x[:, sl].shape[1], h0=hs)
    return torch.stack(out, 2) if out else torch.zeros((b, h, 0, *hs.shape[2:]))


def _k5_bwd_restated(x, dt, A, Bm, Cm, gy, states, g_hlast, with_h0,
                     q=KERNEL_CHUNK, pb=BWD_COLUMNS):
    """csrc/ssd_scan_bwd.cu step for step: per 32 columns of P, the chunks
    from the last, h recomputed forwards from the chunk's entry state
    (gC, C gC), lam walked backwards (gB, gu, <h, lam> at the chunk's
    end), then ga from the q identity by a suffix sum.  Returns the
    kernel's outputs: gx, gdt and ga per column block, gB and gC per
    column block and head, gh0."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    npb, chunks = -(-p // pb), -(-s // q)
    sp, pp = chunks * q, npb * pb
    xp = F.pad(x, (0, pp - p, 0, 0, 0, sp - s))
    gyp = F.pad(gy, (0, pp - p, 0, 0, 0, sp - s))
    dtp = F.pad(dt, (0, 0, 0, sp - s))
    Bp, Cp = (F.pad(m[:, :, 0], (0, 0, 0, sp - s)) for m in (Bm, Cm))
    st = F.pad(states, (0, pp - p))
    gx = torch.zeros((b, sp, h, pp))
    gdt_part, ga_part = torch.zeros((2, npb, b, sp, h))
    gB_part, gC_part = torch.zeros((2, npb, b, sp, h, n))
    gh0 = torch.zeros((b, h, n, pp))
    for k in range(npb):
        cols = slice(k * pb, (k + 1) * pb)
        lam = (torch.zeros((b, h, n, pb)) if g_hlast is None
               else F.pad(g_hlast, (0, pp - p))[..., cols])
        decay_next = torch.ones((b, h))
        for c in reversed(range(chunks)):
            t0 = c * q
            ea = torch.exp(dtp[:, t0:t0 + q] * A)
            u = xp[:, t0:t0 + q, :, cols] * dtp[:, t0:t0 + q, :, None]
            hs = st[:, :, c, :, cols]
            cg = torch.zeros((b, q, h))
            for i in range(q):
                hs = (ea[:, i, :, None, None] * hs
                      + Bp[:, t0 + i][:, None, :, None]
                      * u[:, i][:, :, None, :])
                gc = (hs * gyp[:, t0 + i, :, None, cols]).sum(-1)
                gC_part[k, :, t0 + i] = gc
                cg[:, i] = (Cp[:, t0 + i][:, None, :] * gc).sum(-1)
            gu = torch.zeros((b, q, h, pb))
            for i in reversed(range(q)):
                lam = (decay_next[..., None, None] * lam
                       + Cp[:, t0 + i][:, None, :, None]
                       * gyp[:, t0 + i, :, None, cols])
                if i == q - 1:
                    q_end = (hs * lam).sum((-2, -1))
                gB_part[k, :, t0 + i] = (lam * u[:, i][:, :, None, :]).sum(-1)
                gu[:, i] = (lam * Bp[:, t0 + i][:, None, :, None]).sum(-2)
                decay_next = ea[:, i]
            gx[:, t0:t0 + q, :, cols] = gu * dtp[:, t0:t0 + q, :, None]
            gux = (gu * xp[:, t0:t0 + q, :, cols]).sum(-1)
            d = cg - dtp[:, t0:t0 + q] * gux
            suffix = torch.flip(torch.cumsum(torch.flip(d, [1]), 1), [1])
            ga = (q_end - cg[:, q - 1])[:, None] + suffix
            ga_part[k, :, t0:t0 + q] = ga
            gdt_part[k, :, t0:t0 + q] = gux + ga * A
        gh0[..., cols] = decay_next[..., None, None] * lam
    return (gx[:, :s, :, :p], gdt_part[:, :, :s], ga_part[:, :, :s],
            gB_part[:, :, :s], gC_part[:, :, :s],
            gh0[..., :p] if with_h0 else None)


@pytest.mark.parametrize("s,p,n,with_h0,with_ghl", [
    (64, 8, 16, True, True), (130, 40, 20, False, True),
    (200, 36, 16, True, False), (37, 32, 8, False, False), (1, 4, 4, True, True),
])
def test_kernel_design_equals_plain(s, p, n, with_h0, with_ghl):
    """K5-bwd's algorithm (per 32 columns, the q identity for ga, partial
    sums added as the wrapper adds them) equals the plain backward."""
    a = _inputs(44 + s, b=2, s=s, h=3, p=p, n=n, with_h0=with_h0)
    t = {k: _t(v) for k, v in a.items()}
    ghl = t["g_hlast"] if with_ghl else None
    states = _entry_states(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"])
    gx, gdt_p, ga_p, gB_p, gC_p, gh0 = _k5_bwd_restated(
        t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["gy"], states, ghl,
        with_h0)
    got = [gx, gdt_p.sum(0), (ga_p.sum(0) * t["dt"]).sum((0, 1)),
           gB_p.sum((0, 3))[:, :, None], gC_p.sum((0, 3))[:, :, None], gh0]
    want = ssd_scan_bwd_plain(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                              t["gy"], chunk=s, h0=t["h0"], g_hlast=ghl)
    _assert_grads([None if g is None else g.numpy() for g in got],
                  [None if w is None else w.numpy() for w in want],
                  DESIGN_RTOL)


# --------------------------------------------------------------------------
# SSDScanFunction's routing, with stand-ins for the C functions
# --------------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _on_card(a, grad=False):
    return None if a is None else torch.Tensor._make_subclass(
        _OnCard, torch.tensor(a), grad)


def _at(ptr, shape, strides=None):
    """The float32 array at a host address with element strides."""
    if ptr is None:
        return None
    shape = tuple(int(d) for d in shape)
    if strides is None:
        strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    size = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((ctypes.c_float * size).from_address(ptr))
    return np.lib.stride_tricks.as_strided(
        buf, shape, [4 * int(st) for st in strides])


def _tensor(ptr, shape, strides=None):
    arr = _at(ptr, shape, strides)
    return None if arr is None else torch.tensor(np.array(arr))


def _inputs_at(args, b, s, h, p, n):
    x = _tensor(args[0], (b, s, h, p), (args[1], args[2], p, 1))
    dt = _tensor(args[3], (b, s, h), (args[4], args[5], 1))
    A = _tensor(args[6], (h,))
    Bm = _tensor(args[7], (b, s, 1, n), (args[8], args[9], n, 1))
    Cm = _tensor(args[10], (b, s, 1, n), (args[11], args[12], n, 1))
    return x, dt, A, Bm, Cm


def _fake_forward(calls):
    """ssd_scan_launch's contract: y, h_last and the entry states."""
    def launch(*args):
        b, s, h, p, n = args[17:22]
        x, dt, A, Bm, Cm = _inputs_at(args, b, s, h, p, n)
        h0 = _tensor(args[13], (b, h, n, p))
        y, h_last = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=s, h0=h0)
        states = _entry_states(x, dt, A, Bm, Cm, h0)
        for ptr, val in ((args[14], y), (args[15], h_last),
                         (args[16], states)):
            _at(ptr, val.shape)[...] = val.numpy()
        calls.append("fwd")
        return 0
    return launch


def _fake_backward(calls):
    """ssd_scan_bwd_launch's contract, from the restated kernel."""
    def launch(*args):
        b, s, h, p, n = args[22:27]
        x, dt, A, Bm, Cm = _inputs_at(args, b, s, h, p, n)
        chunks = -(-s // KERNEL_CHUNK)
        gy = _tensor(args[13], (b, s, h, p))
        states = _tensor(args[14], (b, h, chunks, n, p))
        g_hlast = _tensor(args[15], (b, h, n, p))
        outs = _k5_bwd_restated(x, dt, A, Bm, Cm, gy, states, g_hlast,
                                args[21] is not None)
        for ptr, val in zip(args[16:22], outs):
            if val is not None:
                _at(ptr, val.shape)[...] = val.numpy()
        calls.append("bwd")
        return 0
    return launch


@pytest.fixture
def stand_ins(monkeypatch):
    """"cuda" scans on tensors that report is_cuda, with Python stand-ins
    for the kernels' C functions; the CUDA device context and stream
    stubbed, the launch counters at 0."""
    calls = []
    monkeypatch.setattr(ops, "kernel_backend", lambda backend, dev: "cuda")
    monkeypatch.setattr(K, "_lib", lambda: _fake_forward(calls))
    monkeypatch.setattr(K, "_bwd_lib", lambda: _fake_backward(calls))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(K.ssd_scan_cuda, "launches", 0)
    monkeypatch.setattr(ssd_scan_bwd_cuda, "launches", 0)
    return calls


@pytest.mark.parametrize("with_h0,use_hlast", [(False, False), (True, True)])
def test_grad_enabled_scan_runs_k5_bwd_through_the_function(
        stand_ins, with_h0, use_hlast):
    """On the card a scan whose inputs want a gradient goes through
    SSDScanFunction: K5 forward, K5-bwd backward (one launch each), and
    its gradients equal autograd of the plain scan."""
    a = _inputs(45, b=2, s=100, h=3, p=40, n=16, with_h0=with_h0)
    t = {k: _on_card(a[k], grad=True) for k in NAMES}
    y, h_last = ops.ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                             chunk=25, h0=t["h0"])
    assert type(y.grad_fn).__name__ == "SSDScanFunctionBackward"
    loss = torch.sum(y * _t(a["gy"]))
    if use_hlast:
        loss = loss + torch.sum(h_last * _t(a["g_hlast"]))
    else:
        a["g_hlast"] = np.zeros_like(a["g_hlast"])
    loss.backward()
    assert stand_ins == ["fwd", "bwd"]
    assert K.ssd_scan_cuda.launches == 1 and ssd_scan_bwd_cuda.launches == 1
    got = [None if t[k] is None else t[k].grad.numpy() for k in NAMES]
    _assert_grads(got, _autograd_grads(a, 25), DESIGN_RTOL)


def test_no_grad_scan_on_the_card_runs_k5_alone(stand_ins):
    """Under no_grad (serving) the scan is K5 as before: no Function, no
    states kept, no backward."""
    a = _inputs(46, s=64)
    t = {k: _on_card(a[k], grad=True) for k in NAMES}
    with torch.no_grad():
        y, _ = ops.ssd_scan(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                            chunk=16)
    assert y.grad_fn is None and stand_ins == ["fwd"]
    assert ssd_scan_bwd_cuda.launches == 0


def test_backward_kernel_refuses_what_it_cannot_run():
    """The backward's launch contract: one thread a state row (N <= 256),
    its shared memory within the opt-in limit, the entry states' shape."""
    assert bwd_smem_bytes(128) == 4 * (2 * 64 * 128 + 2 * 64 * 32 + 3 * 64
                                       + 4 * (32 * 32 + 64 + 1))
    assert 2 * (bwd_smem_bytes(128) + 1024) <= 228 * 1024   # two CTAs an SM
    assert bwd_smem_bytes(256) <= 227 * 1024
    a = _inputs(47, s=64, n=16)
    t = {k: _on_card(a[k]) for k in NAMES}
    states = _on_card(np.zeros((2, 3, 1, 16, 8), np.float32))
    gy = _on_card(a["gy"])
    with pytest.raises(ValueError, match="states"):
        ssd_scan_bwd_cuda(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], gy,
                          states=states[:, :, :, :8], chunk=16)
    with pytest.raises(ValueError, match="gy"):
        ssd_scan_bwd_cuda(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                          gy[..., :4], states=states, chunk=16)
    big = _on_card(np.zeros((1, 16, 1, 260), np.float32))
    with pytest.raises(NotImplementedError, match="N=260"):
        ssd_scan_bwd_cuda(_on_card(np.zeros((1, 16, 1, 8), np.float32)),
                          _on_card(np.ones((1, 16, 1), np.float32)),
                          _on_card(-np.ones(1, np.float32)), big, big,
                          _on_card(np.zeros((1, 16, 1, 8), np.float32)),
                          states=None, chunk=16)
