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
import functools
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
    BWD_CHUNK_THREADS,
    BWD_COLUMNS,
    BWD_GRID_CTAS,
    BWD_ROWS,
    BWD_STATE_THREADS,
    KERNEL_CHUNK,
    bwd_chunk_smem_bytes,
    bwd_heads_per_cta,
    bwd_launches,
    bwd_state_smem_bytes,
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
# version: the chunk products and ga's four sums add in another order.
# Largest measured 6.2e-6 (gx at 256-step chunks), 3.1e-6 for gA.
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


def _k5_bwd_restated(x, dt, A, Bm, Cm, gy, states, g_hlast, with_h0, hg,
                     q=KERNEL_CHUNK, nbk=BWD_ROWS, pbk=BWD_COLUMNS):
    """csrc/ssd_scan_bwd.cu step for step, with ``hg`` heads a group.

    Launch 1, per block of state rows and columns: the chunks from the
    last, G_c written, the block's exp(total) <H0_c, G_c>, then G_{c-1} =
    exp(total) G_c + C^T diag(exp(a_cum)) gy.  Launch 2, per chunk, block
    and group of heads: C B^T once; per head W~ = gy u^T, M, W and
    E = W * C B^T, gu (its B G_c term apart), gx, <x, gu> and <x, B G_c>,
    gB's G_c term and gC's H0_c term T into the group's sums, ga from the
    base, the suffix of <C, T>, E's rectangles and the prefix of
    v = dt dout <x, B G_c>; then the summed W times B and C.  Returns the
    kernels' outputs: gx per block of rows, gdt and ga per (rows, columns)
    block, gB and gC per (columns, group), gh0."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    chunks, nnb, npb = -(-s // q), -(-n // nbk), -(-p // pbk)
    groups = -(-h // hg)
    sp, np_, pp = chunks * q, nnb * nbk, npb * pbk
    xp = F.pad(x, (0, pp - p, 0, 0, 0, sp - s))
    gyp = F.pad(gy, (0, pp - p, 0, 0, 0, sp - s))
    dtp = F.pad(dt, (0, 0, 0, sp - s))
    Bp, Cp = (F.pad(m[:, :, 0], (0, np_ - n, 0, sp - s)) for m in (Bm, Cm))
    st = F.pad(states, (0, pp - p, 0, np_ - n))
    zero = torch.zeros((b, h, np_, pp))
    ghl = zero if g_hlast is None else F.pad(g_hlast, (0, pp - p, 0, np_ - n))
    rows = [slice(k * nbk, (k + 1) * nbk) for k in range(nnb)]
    cols = [slice(k * pbk, (k + 1) * pbk) for k in range(npb)]

    # Launch 1: the reverse state pass.
    gst = torch.zeros((b, h, chunks, np_, pp))
    base = torch.zeros((nnb, npb, b, h, chunks))
    G = ghl
    for c in reversed(range(chunks)):
        t = slice(c * q, (c + 1) * q)
        a_cum = torch.cumsum(dtp[:, t] * A, 1)              # (b, q, h)
        gst[:, :, c] = G
        for i, nsl in enumerate(rows):
            for k, psl in enumerate(cols):
                base[i, k, ..., c] = torch.exp(a_cum[:, -1]) * (
                    st[:, :, c, nsl, psl] * G[:, :, nsl, psl]).sum((-2, -1))
        D = torch.einsum("bjn,bjhp->bhnp", Cp[:, t],
                         gyp[:, t] * torch.exp(a_cum)[..., None])
        G = torch.exp(a_cum[:, -1])[..., None, None] * G + D

    # Launch 2: every chunk, block and group of heads.
    gx = torch.zeros((nnb, b, sp, h, pp))
    gdt_p, ga_p = torch.zeros((2, nnb, npb, b, sp, h))
    gB_p, gC_p = torch.zeros((2, npb, groups, b, sp, np_))
    for c in range(chunks):
        t = slice(c * q, (c + 1) * q)
        for i, nsl in enumerate(rows):
            Cq, Bq = Cp[:, t, nsl], Bp[:, t, nsl]           # (b, q, nbk)
            CB = Cq @ Bq.transpose(1, 2)
            for k, psl in enumerate(cols):
                for grp in range(groups):
                    wsum = torch.zeros((b, q, q))
                    gBs, gCs = torch.zeros((2, b, q, nbk))
                    for hh in range(grp * hg, min(h, (grp + 1) * hg)):
                        d_t = dtp[:, t, hh]                 # (b, q)
                        a_cum = torch.cumsum(d_t * A[hh], 1)
                        L = segsum_decay(a_cum)
                        ea = torch.exp(a_cum)
                        dout = torch.exp(a_cum[:, -1:] - a_cum)
                        xq, yq = xp[:, t, hh, psl], gyp[:, t, hh, psl]
                        Gc = gst[:, hh, c, nsl, psl]
                        H0 = st[:, hh, c, nsl, psl]
                        W = (yq @ (xq * d_t[..., None]).transpose(1, 2)) * L
                        M = CB * L
                        E = W * CB
                        wsum = wsum + W
                        BG = Bq @ Gc
                        gu = M.transpose(1, 2) @ yq + dout[..., None] * BG
                        gx[i, :, t, hh, psl] = gu * d_t[..., None]
                        ux = (gu * xq).sum(-1)
                        v = d_t * dout * (BG * xq).sum(-1)
                        gBs = gBs + ((xq * (d_t * dout)[..., None])
                                     @ Gc.transpose(1, 2))
                        T = (yq * ea[..., None]) @ H0.transpose(1, 2)
                        tc = (Cq * T).sum(-1)
                        gCs = gCs + T
                        # sum_{r >= i} <C_r, T_r>; sum_{r >= i, j < i} E[r, j]
                        # (rows' exclusive prefixes, then columns from the
                        # diagonal down); sum_{j < i} v_j.
                        suffix = torch.flip(torch.cumsum(
                            torch.flip(tc, [1]), 1), [1])
                        Fr = torch.cumsum(E, 2) - E
                        rect = (Fr * torch.tril(torch.ones(q, q))).sum(1)
                        prefix = torch.cumsum(v, 1) - v
                        ga = (base[i, k, :, hh, c][:, None] + suffix + rect
                              + prefix)
                        ga_p[i, k, :, t, hh] = ga
                        gdt_p[i, k, :, t, hh] = ux + ga * A[hh]
                    gB_p[k, grp, :, t, nsl] = gBs + wsum.transpose(1, 2) @ Cq
                    gC_p[k, grp, :, t, nsl] = gCs + wsum @ Bq
    return (gx[:, :, :s, :, :p], gdt_p[..., :s, :], ga_p[..., :s, :],
            gB_p[..., :s, :n], gC_p[..., :s, :n],
            G[:, :, :n, :p] if with_h0 else None)


def _restated_grads(a, with_ghl, hg):
    """The restated kernels' outputs from ``a``'s inputs, their parts added
    as ``ssd_scan_bwd_cuda`` adds them."""
    t = {k: _t(v) for k, v in a.items()}
    ghl = t["g_hlast"] if with_ghl else None
    states = _entry_states(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["h0"])
    gx, gdt_p, ga_p, gB_p, gC_p, gh0 = _k5_bwd_restated(
        t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["gy"], states, ghl,
        t["h0"] is not None, hg)
    parts = [functools.reduce(torch.add,
                              g.reshape(-1, *g.shape[d:]).unbind(0))
             for g, d in ((gx, 1), (gdt_p, 2), (ga_p, 2), (gB_p, 2),
                          (gC_p, 2))]
    gx, gdt, ga, gB, gC = parts
    return [gx, gdt, (ga * t["dt"]).sum((0, 1)), gB[:, :, None],
            gC[:, :, None], gh0]


@pytest.mark.parametrize("b,s,h,p,n,with_h0,with_ghl,hg,const_dt", [
    (2, 64, 3, 8, 16, True, True, 2, None),
    (2, 130, 3, 40, 20, False, True, 3, None),
    (2, 200, 3, 36, 16, True, False, 1, None),
    (2, 37, 3, 32, 8, False, False, 2, None),
    (2, 1, 3, 4, 4, True, True, 3, None),
    # Mamba2-130M's init over 256-step chunks: the reference reads NaN.
    (1, 256, 2, 8, 16, False, False, 2, 0.69),
    # More than one block of state rows (the second ragged) and of columns.
    (1, 100, 3, 72, 136, True, True, 2, None),
])
def test_kernel_design_equals_plain(b, s, h, p, n, with_h0, with_ghl, hg,
                                    const_dt):
    """K5-bwd's algorithm (the reverse state pass, the chunk kernel's
    products, the ga suffix, the parts added as the wrapper adds them)
    equals the plain backward."""
    a = _inputs(44 + s, b=b, s=s, h=h, p=p, n=n, with_h0=with_h0,
                const_dt=const_dt)
    got = _restated_grads(a, with_ghl, hg)
    t = {k: _t(v) for k, v in a.items()}
    chunk = 256 if const_dt is not None else s
    want = ssd_scan_bwd_plain(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                              t["gy"], chunk=chunk, h0=t["h0"],
                              g_hlast=t["g_hlast"] if with_ghl else None)
    _assert_grads([None if g is None else g.numpy() for g in got],
                  [None if w is None else w.numpy() for w in want],
                  DESIGN_RTOL)
    if const_dt is not None:
        ref = _ref_grads({**a, "g_hlast": np.zeros_like(a["g_hlast"])}, 256)
        assert np.isnan(ref[1]).any()


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
    """ssd_scan_bwd_launch's contract, from the restated kernels."""
    def launch(*args):
        b, s, h, p, n, hg = args[24:30]
        x, dt, A, Bm, Cm = _inputs_at(args, b, s, h, p, n)
        chunks = -(-s // KERNEL_CHUNK)
        gy = _tensor(args[13], (b, s, h, p))
        states = _tensor(args[14], (b, h, chunks, n, p))
        g_hlast = _tensor(args[15], (b, h, n, p))
        outs = _k5_bwd_restated(x, dt, A, Bm, Cm, gy, states, g_hlast,
                                args[23] is not None, hg)
        for ptr, val in zip(args[18:24], outs):
            if val is not None:
                _at(ptr, val.shape)[...] = val.numpy()
        calls.append(("bwd", hg))
        return 0
    return launch


@pytest.fixture
def stand_ins(monkeypatch):
    """"cuda" scans on tensors that report is_cuda, with Python stand-ins
    for the kernels' C functions; the CUDA device context and stream
    stubbed, a chunk grid aimed at 8 CTAs (so that a CTA walks more than
    one head), the launch counters at 0."""
    calls = []
    monkeypatch.setattr(ops, "kernel_backend", lambda backend, dev: "cuda")
    monkeypatch.setattr(K, "_lib", lambda: _fake_forward(calls))
    monkeypatch.setattr(K, "_bwd_lib", lambda: _fake_backward(calls))
    monkeypatch.setattr(K, "BWD_GRID_CTAS", 8)
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
    # 4 CTAs a head (2 chunks x 2 batches) for 8: groups of 2 heads and
    # 1.
    assert stand_ins == ["fwd", ("bwd", 2)]
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
    """The backward's launch contract: two CTAs whose shared memory does
    not grow with N or P (blocks of 128 state rows and 64 columns), each
    within the opt-in limit; the grids at the training shape; N bounded
    only by the forward's limit; the entry states', gy's and g_hlast's
    shapes."""
    q = KERNEL_CHUNK
    assert bwd_state_smem_bytes() == 4 * (3 * (q * 136 + q * 72 + q) + q + 4
                                          + BWD_STATE_THREADS // 32)
    assert bwd_chunk_smem_bytes() == 4 * (2 * q * 132 + 2 * q * 68 + 128 * 72
                                          + 128 * 68 + q * 72 + q * 68
                                          + (5 + 12 + 8) * q)
    assert bwd_chunk_smem_bytes() == 216_320                # one CTA an SM
    assert 2 * bwd_chunk_smem_bytes() > 228 * 1024
    assert max(bwd_state_smem_bytes(), bwd_chunk_smem_bytes()) <= 227 * 1024
    # B=4, S=1024, H=24, P=64, N=128 for 132 SMs: 12 heads a CTA, 128
    # CTAs, whatever the card.
    assert BWD_GRID_CTAS == 132
    assert bwd_heads_per_cta(4, 1024, 24, 64, 128) == 12
    assert bwd_launches(4, 1024, 24, 64, 128) == [
        {"kernel": "state_bwd_kernel", "grid": (1, 24, 4),
         "threads": BWD_STATE_THREADS, "smem": bwd_state_smem_bytes()},
        {"kernel": "chunk_bwd_kernel", "grid": (16, 2, 4),
         "threads": BWD_CHUNK_THREADS, "smem": bwd_chunk_smem_bytes()}]
    # N = 192 (two blocks of rows) and P = 128 (two of columns) at S = 1000.
    assert [d["grid"] for d in bwd_launches(2, 1000, 3, 128, 192)] == [
        (2, 3, 4), (32, 1, 4)]
    assert [d["kernel"] for d in bwd_launches(1, 0, 2, 8, 16)] == [
        "state_bwd_kernel"]
    assert (BWD_ROWS, BWD_COLUMNS) == (128, 64)
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
    with pytest.raises(ValueError, match="g_hlast"):
        ssd_scan_bwd_cuda(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], gy,
                          states=states, chunk=16,
                          g_hlast=_on_card(a["g_hlast"])[:, :, :8])

    def at_n(n):
        return [_on_card(np.zeros((1, 16, 1, 8), np.float32)),
                _on_card(np.ones((1, 16, 1), np.float32)),
                _on_card(-np.ones(1, np.float32)),
                _on_card(np.zeros((1, 16, 1, n), np.float32)),
                _on_card(np.zeros((1, 16, 1, n), np.float32)),
                _on_card(np.zeros((1, 16, 1, 8), np.float32))]

    # N = 260 (three blocks of rows), refused by the old one-thread-a-row
    # kernel, passes every check and reaches the C function with its
    # gradients' parts shaped for three blocks; N = 384 passes the
    # forward's shared-memory limit and is refused by it.
    seen = []

    def record(*args):
        seen.append(args[24:30])
        return 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "_bwd_lib", lambda: record)
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        mp.setattr(torch.cuda, "current_stream",
                   lambda: types.SimpleNamespace(cuda_stream=0))
        mp.setattr(ssd_scan_bwd_cuda, "launches", 0)
        gx = ssd_scan_bwd_cuda(
            *at_n(260), states=_on_card(np.zeros((1, 1, 1, 260, 8),
                                                 np.float32)), chunk=16)[0]
        assert seen == [(1, 16, 1, 8, 260, 1)] and gx.shape == (1, 16, 1, 8)
        with pytest.raises(NotImplementedError, match="N=384"):
            ssd_scan_bwd_cuda(*at_n(384), states=None, chunk=16)
