"""K5: the Mamba-2 SSD chunked scan as a hand-written CUDA kernel.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (body
``_ssd_kernel``).  Source: ``csrc/ssd_scan.cu``, built for ``sm_90a`` by
``kernels/_build.py``.

Per (batch, head), in fp32::

    h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T ;   y_t = C_t h_t

seeded from ``h0`` (zero when ``None``; the TPU kernel always starts from
zero), returning the final state ``h_last`` beside ``y``, which prefill
stores in the cache.

What bounds it on an H100: operations, on the tensor cores.  One call
makes two CUDA launches over 64-step chunks: a state scan (the SSD
algorithm's chunk states and state passing, each CTA walking the chunks
with its block of the state in registers) writes the state entering each
chunk, and a chunk scan computes every chunk of every (batch, head) at
once from it.  The TPU kernel's ordered grid and VMEM carry become the
state scan's walk.  The four products run as 3xTF32 ``mma.sync`` (an fp32
operand split into two TF32 halves, three products), which keeps about
fp32 accuracy where plain TF32 would not.  The kernel's chunk does not
follow ``chunk``: the result does not depend on the chunk length apart
from rounding (csrc/ssd_scan.cu says how it is laid out).

``ssd_scan_cuda`` launches the kernel for a CUDA tensor and runs
``ssd_scan_plain`` (a restatement of ``ssd_chunked``'s chunk loop) only
for a CPU tensor; a meta tensor gets the launch's checks and meta results
of the kernel's shapes, no launch (the dry run's abstract evaluation,
which counts ``ssd_scan_work``).  ``ssd_scan_cuda.launches`` counts calls
that launched the kernel (two CUDA launches each: the state scan and the
chunk scan).

K5-bwd (``csrc/ssd_scan_bwd.cu``, no TPU counterpart: the reference
differentiates its jnp chunk loop) computes the scan's gradients in K5's
chunk-parallel form run backwards, from the state entering each 64-step
chunk, which K5 writes and ``SSDScanFunction`` keeps: a reverse state pass
(the gradient of the state leaving each chunk) and a chunk kernel (every
chunk at once, gB and gC summed over a group of heads inside), both on
3xTF32 ``mma.sync``.  ``ssd_scan_bwd_cuda`` launches it for a CUDA tensor
(two CUDA launches a call, counted once in ``ssd_scan_bwd_cuda.launches``)
and runs ``ssd_scan_bwd_plain`` for a CPU tensor (a meta tensor as for
K5, counting ``ssd_scan_bwd_work``).  ``ops.ssd_scan`` routes
a grad-enabled CUDA scan through ``SSDScanFunction``; nothing on the card
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.specs import SMEM_LIMIT_BYTES, abstract_launch

KERNEL_CHUNK = 64               # steps of one chunk inside the kernel
_GRID_LIMIT = 65535             # CUDA's cap on grid dims y and z


def segsum_decay(a_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(a_cum_i - a_cum_j) for j <= i else 0.  a_cum: (..., Q).

    Masked before the ``exp``: above the diagonal the difference is
    positive and passes fp32's ``exp`` range once the summed ``dt |A|``
    between two steps of a chunk passes 88 (at init, 128 steps apart), and
    the ``where`` of an ``exp`` would carry ``0 * inf = NaN`` into the
    gradient.  ``exp(-inf) = 0``, so the values are those of
    ``where(tril, exp(diff), 0)`` bit for bit."""
    q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=a_cum.device))
    return torch.exp(torch.where(tri, diff, -torch.inf))


def check_inputs(x, dt, A, Bm, Cm, chunk: int, h0=None) -> None:
    """The scan's input contract, checked before any pointer is passed:
    x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N) with G
    dividing H, h0 (B, H, N, P) or None; all float32 on one device; S a
    multiple of ``chunk`` (pad with dt = 0 upstream: identity steps)."""
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    if h0 is not None:
        tensors["h0"] = h0
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    b, s, h, p = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError(
            f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x "
            f"{tuple(x.shape)}: want dt {(b, s, h)}, A {(h,)}")
    if Bm.ndim != 4 or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(
            f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} must both be "
            f"({b}, {s}, G, N)")
    g, n = Bm.shape[2], Bm.shape[3]
    if g < 1 or h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if h0 is not None and tuple(h0.shape) != (b, h, n, p):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(b, h, n, p)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """Plain torch K5: ``ssd_chunked``'s chunk loop, any number of groups.

    Returns (y (B, S, H, P), h_last (B, H, N, P)), fp32."""
    check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    hstate = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
              if h0 is None else h0)
    ys = []
    for c0 in range(0, s, chunk):
        xq, dtq = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bq, Cq = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]
        a = dtq * A                                     # (B,Q,H) log-decays
        a_cum = torch.cumsum(a, dim=1)                  # (B,Q,H)
        scores = torch.einsum("bqgn,bsgn->bgqs", Cq, Bq)
        Lmask = segsum_decay(a_cum.transpose(1, 2))     # (B,H,Q,Q)
        M = scores[:, :, None] * Lmask.reshape(b, g, hg, chunk, chunk)
        xdtg = (xq * dtq[..., None]).reshape(b, chunk, g, hg, p)
        y_intra = torch.einsum("bghqs,bsghp->bqghp", M, xdtg)
        y_inter = torch.einsum("bqgn,bghnp->bqghp", Cq,
                               hstate.reshape(b, g, hg, n, p))
        y_inter = y_inter * torch.exp(a_cum).reshape(b, chunk, g, hg)[..., None]
        ys.append((y_intra + y_inter).reshape(b, chunk, h, p))
        total = a_cum[:, -1]                            # (B,H)
        decay_out = torch.exp(total[:, None] - a_cum)   # (B,Q,H)
        state_new = torch.einsum(
            "bqgn,bqghp->bghnp", Bq,
            xdtg * decay_out.reshape(b, chunk, g, hg)[..., None])
        hstate = (hstate * torch.exp(total)[..., None, None]
                  + state_new.reshape(b, h, n, p))
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((b, 0, h, p))
    return y, hstate


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, gy, *, chunk: int, h0=None,
                       g_hlast=None):
    """Plain torch K5-bwd: the scan's gradients, chunk by chunk.

    With ``a_t = dt_t A``, ``u_t = dt_t x_t`` and the forward's
    ``h_t = exp(a_t) h_{t-1} + B_t u_t^T``, ``y_t = h_t^T C_t``, the
    gradient ``lam_t`` of the loss in ``h_t`` runs backwards from
    ``g_hlast``::

        lam_t = C_t gy_t^T + exp(a_{t+1}) lam_{t+1}
        gu_t = lam_t^T B_t      gB_t = lam_t u_t      gC_t = h_t gy_t
        ga_t = exp(a_t) <h_{t-1}, lam_t>              g_h0 = exp(a_1) lam_1

    and ``gx = gu dt``, ``gdt = <gu, x> + ga A``, ``gA = sum_{b,t} ga dt``;
    gB and gC sum the heads of a group.  Each chunk holds its ``h_t`` and
    ``lam_t`` unrolled from the state entering it and the gradient leaving
    it, every decay the ``exp`` of a non-positive number.  ``gy`` is
    (B, S, H, P), ``g_hlast`` (B, H, N, P) or None (zero).

    Returns (gx, gdt, gA, gBm, gCm, gh0) fp32, shaped as the inputs;
    ``gh0`` is None when ``h0`` is."""
    check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    if tuple(gy.shape) != (b, s, h, p):
        raise ValueError(f"gy {tuple(gy.shape)} != {(b, s, h, p)}")
    zero = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    # The state entering each chunk, from the forward's chunk loop.
    enters, hstate = [], zero if h0 is None else h0
    for c0 in range(0, s, chunk):
        enters.append(hstate)
        sl = slice(c0, c0 + chunk)
        _, hstate = ssd_scan_plain(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                   Cm[:, sl], chunk=chunk, h0=hstate)
    # (B, H, S, ...) per head: B and C repeated over the heads of a group.
    Bh = Bm.repeat_interleave(hg, dim=2).transpose(1, 2)
    Ch = Cm.repeat_interleave(hg, dim=2).transpose(1, 2)
    a = (dt * A).transpose(1, 2)                        # (B,H,S)
    u = (x * dt[..., None]).transpose(1, 2)             # (B,H,S,P)
    gyh = gy.transpose(1, 2)
    gu = torch.empty_like(u)
    gB = torch.empty((b, h, s, n), dtype=torch.float32, device=x.device)
    gC = torch.empty_like(gB)
    ga = torch.empty_like(a)
    lam_out = zero if g_hlast is None else g_hlast      # gradient leaving
    for c0 in reversed(range(0, s, chunk)):
        sl = slice(c0, c0 + chunk)
        a_cum = torch.cumsum(a[..., sl], -1)            # (B,H,Q)
        L = segsum_decay(a_cum)                         # L[i, j], j <= i
        Bq, Cq, uq, gq = Bh[:, :, sl], Ch[:, :, sl], u[:, :, sl], gyh[:, :, sl]
        q = a_cum.shape[-1]
        # h_i = exp(a_cum_i) h_enter + sum_{j <= i} L[i, j] B_j u_j^T
        bu = (Bq[..., :, None] * uq[..., None, :]).reshape(b, h, q, n * p)
        hs = ((L @ bu).reshape(b, h, q, n, p)
              + torch.exp(a_cum)[..., None, None] * enters[c0 // chunk][
                  :, :, None])
        # lam_i = sum_{r >= i} L[r, i] C_r gy_r^T
        #         + exp(a_cum_end - a_cum_i) lam_out
        cg = (Cq[..., :, None] * gq[..., None, :]).reshape(b, h, q, n * p)
        decay_out = torch.exp(a_cum[..., -1:] - a_cum)
        lam = ((L.transpose(-1, -2) @ cg).reshape(b, h, q, n, p)
               + decay_out[..., None, None] * lam_out[:, :, None])
        gu[:, :, sl] = torch.einsum("bhinp,bhin->bhip", lam, Bq)
        gB[:, :, sl] = torch.einsum("bhinp,bhip->bhin", lam, uq)
        gC[:, :, sl] = torch.einsum("bhinp,bhip->bhin", hs, gq)
        h_prev = torch.cat([enters[c0 // chunk][:, :, None], hs[:, :, :-1]],
                           dim=2)
        ea = torch.exp(a[..., sl])
        ga[..., sl] = ea * (h_prev * lam).sum((-2, -1))
        lam_out = ea[..., 0, None, None] * lam[:, :, 0]
    gu, ga = gu.transpose(1, 2), ga.transpose(1, 2)     # (B,S,H,...)
    gx = gu * dt[..., None]
    gdt = (gu * x).sum(-1) + ga * A
    gA = (ga * dt).sum((0, 1))
    gBm = gB.transpose(1, 2).reshape(b, s, g, hg, n).sum(3)
    gCm = gC.transpose(1, 2).reshape(b, s, g, hg, n).sum(3)
    return gx, gdt, gA, gBm, gCm, None if h0 is None else lam_out


def ssd_scan_work(b: int, s: int, h: int, p: int, n: int, *,
                  h0: bool = False, chunk: int = KERNEL_CHUNK) -> dict:
    """What one K5 call must do, the yardstick of its bound and of the dry
    run.  ``bytes``: x, dt, A, B, C (and h0) read once, y and h_last
    written once.  ``flops``: what the function needs, the recurrence's
    decay, update and read-out of the (N, P) state, 4 N P a (batch, head,
    step).  ``form_flops``: the SSD form's full products at chunk length
    ``chunk``, 2 Q (Q N + Q P + 2 N P) a (batch, head) chunk of Q steps,
    which a chunked kernel does instead, more the longer its chunk."""
    state = b * h * n * p
    read = (b * s * h * p + b * s * h + h + 2 * b * s * n
            + (state if h0 else 0))
    return {"bytes": 4 * (read + b * s * h * p + state),
            "flops": 4 * b * h * s * n * p,
            "form_flops": 2 * b * h * s * (chunk * (n + p) + 2 * n * p)}


def ssd_scan_bwd_work(b: int, s: int, h: int, p: int, n: int, *,
                      h0: bool = False, g_hlast: bool = False) -> dict:
    """What one K5-bwd call must do.  ``bytes``: x, dt, B, C, gy, the
    states K5 kept (and g_hlast) read once, gx, gdt, gA, gB and gC (and
    gh0) written once.  ``flops``: five multiply-adds per state element
    a step (h, gC, lam, gB, gu), 10 N P a (batch, head, step).
    ``form_flops``: the chunk form's full products a 64-step chunk, per
    head C^T gy (the reverse pass), gy u^T, M^T gy, B G, u G^T and
    gy H0^T, 2 Q (4 N P + 2 Q P); per group of heads
    (``bwd_heads_per_cta``) C B^T, W B and W^T C, 6 Q Q N."""
    q, state = KERNEL_CHUNK, b * h * n * p
    kept = b * h * -(-s // q) * n * p
    inputs = b * s * h * p + b * s * h + 2 * b * s * n
    read = inputs + b * s * h * p + kept + (state if g_hlast else 0)
    written = inputs + h + (state if h0 else 0)
    groups = -(-h // bwd_heads_per_cta(b, s, h, p, n))
    return {"bytes": 4 * (read + written),
            "flops": 10 * b * h * s * n * p,
            "form_flops": 2 * b * s * (h * (4 * n * p + 2 * q * p)
                                       + groups * 3 * q * n)}


def scan_smem_bytes(n: int) -> int:
    """Dynamic shared memory of one chunk-scan CTA (csrc/ssd_scan.cu's
    ``scan_smem_floats``): C, B (then a head's entering state in its
    place), xdt and the masked scores of one 64-step chunk and 64 columns
    of P, padded against bank conflicts, and a head's dt and a_cum."""
    q, pb = KERNEL_CHUNK, 64
    n_pad = -(-n // 32) * 32
    c_rows = q * (n_pad + 4)
    return 4 * (c_rows + max(n_pad * (pb + 8), c_rows) + q * (pb + 8)
                + q * (q + 4) + 2 * q)


def state_smem_bytes() -> int:
    """Dynamic shared memory of one state-scan CTA (``state_smem_floats``):
    three buffers of a chunk's B block (128 state rows), x rows and dt,
    then the chunk's scales and total."""
    q, pb, nb, stages = KERNEL_CHUNK, 64, 128, 3
    return 4 * (stages * (q * (nb + 8) + q * (pb + 8) + q) + q + 4)


def smem_bytes(p: int, n: int) -> int:
    """Dynamic shared memory of the larger of K5's two CTAs.  It does not
    grow with P, which the launches split into blocks of 64 columns."""
    return max(scan_smem_bytes(n), state_smem_bytes())


def _check_kernel_inputs(x, dt, Bm, Cm, h0) -> None:
    """What the CUDA kernel takes beyond ``check_inputs``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if g != 1:
        raise NotImplementedError(
            f"the SSD kernel runs one group (G=1), got G={g}; the reference "
            "kernel takes Bm[:, :, 0] likewise")
    if p % 4 or n % 4:
        raise NotImplementedError(
            f"the SSD kernel needs head_dim and state multiples of 4, got "
            f"P={p}, N={n}")
    if smem_bytes(p, n) > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"P={p}, N={n} needs {smem_bytes(p, n)} B of shared memory")
    if b * -(-p // 64) > _GRID_LIMIT or h > _GRID_LIMIT:
        raise NotImplementedError(
            f"B={b}, H={h}, P={p} exceeds the kernel's grid")
    dense_inner = {
        "x": x.stride(-1) == 1 and (x.stride(-2) == p or h == 1),
        "dt": dt.stride(-1) == 1 or h == 1,
        "Bm": Bm.stride(-1) == 1 or n == 1,
        "Cm": Cm.stride(-1) == 1 or n == 1,
    }
    if h0 is not None:
        dense_inner["h0"] = h0.is_contiguous()
    bad = [k for k, ok in dense_inner.items() if not ok]
    if bad:
        raise ValueError(
            f"{bad}: the SSD kernel reads batch and sequence strides but "
            "needs the inner dims dense (x's (H, P), dt's H, Bm/Cm's N, a "
            "contiguous h0)")


def _aligned16(t: torch.Tensor) -> bool:
    """Rows start on 16 bytes: the base and the batch and sequence strides
    (in fp32 elements) are multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and (
        t.ndim < 2 or t.stride(1) % 4 == 0)


def _lib():
    from repro_torch.kernels import _build

    fn = _build.library("ssd_scan.cu").ssd_scan_launch
    if fn.argtypes is None:
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ll, ll, ptr, ll, ll, ptr, ptr, ll, ll, ptr, ll,
                       ll, ptr, ptr, ptr, ptr, i, i, i, i, i, ptr]
        fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int, h0=None,
                  return_states: bool = False):
    """The SSD scan; (y (B, S, H, P), h_last (B, H, N, P)) fp32.

    Args:
      x: (B, S, H, P) float32 values, (H, P) dense.
      dt: (B, S, H) float32 positive step sizes, H dense.
      A: (H,) float32 negative decay rates.
      Bm, Cm: (B, S, 1, N) float32, N dense (G = 1 only on the card).
      chunk: S must be a multiple of it, as for the reference kernel.
      h0: optional (B, H, N, P) contiguous float32 initial state.
      return_states: also return the state entering each 64-step chunk,
        (B, H, ceil(S / 64), N, P) (None on the CPU): what
        ``SSDScanFunction`` keeps for the backward kernel.

    A CPU tensor runs ``ssd_scan_plain``; a CUDA tensor launches K5 or
    raises; a meta tensor gets meta results of those shapes, and
    ``ssd_scan_work`` goes to ``specs.abstract_launch``.
    """
    check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    _check_kernel_inputs(x, dt, Bm, Cm, h0)
    if not (x.is_cuda or x.is_meta):
        out = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        return (*out, None) if return_states else out
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if x.is_meta:           # the launch's checks ran, nothing launches
        abstract_launch("ssd_scan", ssd_scan_work(b, s, h, p, n,
                                                  h0=h0 is not None))
        y, h_last, states = (torch.empty(shape, dtype=torch.float32,
                                         device=x.device) for shape in (
            (b, s, h, p), (b, h, n, p),
            (b, h, -(-s // KERNEL_CHUNK), n, p)))
        return (y, h_last, states) if return_states else (y, h_last)
    A = A.contiguous()
    # The kernel copies 16-byte pieces of x, B, C and h0: a view that does
    # not start (or step) on 16 bytes is copied first.
    x, Bm, Cm = (t if _aligned16(t) else t.clone() for t in (x, Bm, Cm))
    if h0 is not None and not _aligned16(h0):
        h0 = h0.clone()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    # The state entering each 64-step chunk: scratch of the chunk scan,
    # kept for the backward.
    states = torch.empty((b, h, -(-s // KERNEL_CHUNK), n, p),
                         dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.stride(0), x.stride(1),
                 dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
                 Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
                 Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
                 None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_last.data_ptr(), states.data_ptr(),
                 b, s, h, p, n,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan_cuda.launches += 1
    return (y, h_last, states) if return_states else (y, h_last)


ssd_scan_cuda.launches = 0


# ---------------------------------------------------------------------------
# K5-bwd: the gradients (csrc/ssd_scan_bwd.cu)
# ---------------------------------------------------------------------------
BWD_ROWS = 128                  # state rows (of N) a backward CTA owns
BWD_COLUMNS = 64                # columns of P a backward CTA owns
BWD_STATE_THREADS = 256         # the reverse state pass: 8 warps
BWD_CHUNK_THREADS = 512         # the chunk kernel: 16 warps, one CTA an SM
BWD_GRID_CTAS = 132             # the chunk grid's aim: an H100 SXM's SMs


def bwd_state_smem_bytes() -> int:
    """Dynamic shared memory of one reverse-state-pass CTA
    (csrc/ssd_scan_bwd.cu's ``state_bwd_smem_floats``): three buffers of a
    64-step chunk's C block (128 state rows), gy columns and dt, then the
    chunk's scales and total and the warps' parts of <H0, G>."""
    q, stages = KERNEL_CHUNK, 3
    return 4 * (stages * (q * (BWD_ROWS + 8) + q * (BWD_COLUMNS + 8) + q)
                + q + 4 + BWD_STATE_THREADS // 32)


def bwd_chunk_smem_bytes() -> int:
    """Dynamic shared memory of one chunk-kernel CTA
    (``chunk_bwd_smem_floats``): a chunk's C and B blocks, a head's x and
    gy columns, its G_c and H0_c blocks, the masked scores M, the products
    E behind ga and 25 per-step vectors.  Neither CTA grows with N or P,
    which the launches cut into blocks of 128 rows and 64 columns."""
    q, nb, pb = KERNEL_CHUNK, BWD_ROWS, BWD_COLUMNS
    vectors = 5 + 3 * 4 + BWD_CHUNK_THREADS // q
    return 4 * (2 * q * (nb + 4) + 2 * q * (pb + 4) + nb * (pb + 8)
                + nb * (pb + 4) + q * (q + 8) + q * (q + 4) + vectors * q)


def bwd_heads_per_cta(b: int, s: int, h: int, p: int, n: int) -> int:
    """Heads one chunk-kernel CTA walks: as many as still leave a CTA for
    each of ``BWD_GRID_CTAS`` SMs (it takes one CTA an SM).  It follows
    from the shape alone, not from the card: gB and gC are summed over a
    CTA's heads, so the group fixes their rounding, and a run resumed on
    another card goes on bit-equal."""
    per_head = (-(-s // KERNEL_CHUNK) * -(-n // BWD_ROWS) * b
                * -(-p // BWD_COLUMNS))
    return min(h, max(1, -(-per_head * h // BWD_GRID_CTAS)))


def bwd_launches(b: int, s: int, h: int, p: int, n: int) -> list[dict]:
    """K5-bwd's CUDA launches for one call, in order: each kernel's name,
    grid, threads and dynamic shared bytes.  The chunk kernel does not run
    when S = 0."""
    chunks, nnb = -(-s // KERNEL_CHUNK), -(-n // BWD_ROWS)
    npb = -(-p // BWD_COLUMNS)
    out = [{"kernel": "state_bwd_kernel", "grid": (nnb, h, b * npb),
            "threads": BWD_STATE_THREADS, "smem": bwd_state_smem_bytes()}]
    if chunks:
        groups = -(-h // bwd_heads_per_cta(b, s, h, p, n))
        out.append({"kernel": "chunk_bwd_kernel",
                    "grid": (chunks * nnb, groups, b * npb),
                    "threads": BWD_CHUNK_THREADS,
                    "smem": bwd_chunk_smem_bytes()})
    return out


def _check_bwd_inputs(x, gy, states, g_hlast, n: int) -> None:
    """What the backward kernels take beyond the forward's inputs (whose
    limits, checked by ``_check_kernel_inputs``, bound them too)."""
    b, s, h, p = x.shape
    want = {"gy": (gy, (b, s, h, p)),
            "states": (states, (b, h, -(-s // KERNEL_CHUNK), n, p))}
    if g_hlast is not None:
        want["g_hlast"] = (g_hlast, (b, h, n, p))
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"{name} must be a float32 {shape} tensor on {x.device}, got "
                f"{getattr(t, 'dtype', type(t))} "
                f"{tuple(getattr(t, 'shape', ()))}")


def _dense16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, starting on 16 bytes (copied where it does not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _add_parts(t: torch.Tensor, dims: int) -> torch.Tensor:
    """t summed over its ``dims`` leading axes of parts, one add after
    another in a fixed order (a single part is returned as it is)."""
    parts = t.reshape(-1, *t.shape[dims:]).unbind(0)
    return functools.reduce(torch.add, parts)


def _bwd_lib():
    from repro_torch.kernels import _build

    fn = _build.library("ssd_scan_bwd.cu").ssd_scan_bwd_launch
    if fn.argtypes is None:
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ptr, ll, ll, ptr, ll, ll, ptr, ptr, ll, ll, ptr, ll,
                        ll] + [ptr] * 11 + [i] * 6 + [ptr])
        fn.restype = ctypes.c_int
    return fn


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, *, states, chunk: int, h0=None,
                      g_hlast=None):
    """The SSD scan's gradients: (gx, gdt, gA, gBm, gCm, gh0) fp32.

    Args:
      x, dt, A, Bm, Cm, h0, chunk: the forward's inputs (``ssd_scan_cuda``).
      gy: (B, S, H, P) float32, the gradient in y.
      states: (B, H, ceil(S / 64), N, P) float32, the state entering each
        64-step chunk, as ``ssd_scan_cuda(..., return_states=True)`` gives
        it (it holds h0; None on the CPU).
      g_hlast: optional (B, H, N, P) float32 gradient in h_last.

    ``gh0`` is None when ``h0`` is.  A CPU tensor runs
    ``ssd_scan_bwd_plain``; a CUDA tensor launches K5-bwd or raises; a
    meta tensor gets meta gradients, and ``ssd_scan_bwd_work`` goes to
    ``specs.abstract_launch``.  The
    kernels write gB and gC per head group (summed over its heads inside)
    and, where N or P spans more than one block of 128 rows or 64 columns,
    gx, gdt and ga per block; those parts are added here in a fixed order
    (no atomics: the gradients are the same from run to run).
    """
    check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    _check_kernel_inputs(x, dt, Bm, Cm, h0)
    if not (x.is_cuda or x.is_meta):
        return ssd_scan_bwd_plain(x, dt, A, Bm, Cm, gy, chunk=chunk, h0=h0,
                                  g_hlast=g_hlast)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    _check_bwd_inputs(x, gy, states, g_hlast, n)
    if x.is_meta:           # the launch's checks ran, nothing launches
        abstract_launch("ssd_scan_bwd", ssd_scan_bwd_work(
            b, s, h, p, n, h0=h0 is not None, g_hlast=g_hlast is not None))
        return tuple(None if t is None else torch.empty(
            t.shape, dtype=torch.float32, device=x.device)
            for t in (x, dt, A, Bm, Cm, h0))
    A = A.contiguous()
    # The kernels copy 16-byte pieces of x, B, C, gy and the states.
    x, Bm, Cm = (t if _aligned16(t) else t.clone() for t in (x, Bm, Cm))
    gy, states = _dense16(gy), _dense16(states)
    if g_hlast is not None:
        g_hlast = g_hlast.contiguous()
    chunks, nnb = -(-s // KERNEL_CHUNK), -(-n // BWD_ROWS)
    npb = -(-p // BWD_COLUMNS)
    hg = bwd_heads_per_cta(b, s, h, p, n)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    gstates, base = out(b, h, chunks, n, p), out(nnb, npb, b, h, chunks)
    gx = out(nnb, b, s, h, p)
    gdt_part, ga_part = out(nnb, npb, b, s, h), out(nnb, npb, b, s, h)
    gB_part, gC_part = (out(npb, -(-h // hg), b, s, n) for _ in range(2))
    gh0 = None if h0 is None else out(b, h, n, p)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _bwd_lib()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.stride(0), x.stride(1),
                 dt.data_ptr(), dt.stride(0), dt.stride(1), A.data_ptr(),
                 Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
                 Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
                 gy.data_ptr(), states.data_ptr(), ptr(g_hlast),
                 gstates.data_ptr(), base.data_ptr(), gx.data_ptr(),
                 gdt_part.data_ptr(), ga_part.data_ptr(), gB_part.data_ptr(),
                 gC_part.data_ptr(), ptr(gh0), b, s, h, p, n, hg,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(
            f"ssd_scan backward kernel launch failed: CUDA error {err}")
    ssd_scan_bwd_cuda.launches += 1
    ga = _add_parts(ga_part, 2)
    return (_add_parts(gx, 1), _add_parts(gdt_part, 2), (ga * dt).sum((0, 1)),
            _add_parts(gB_part, 2)[:, :, None],
            _add_parts(gC_part, 2)[:, :, None], gh0)


ssd_scan_bwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor], chunk: int,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 as a torch operator: (y, h_last, the state entering each 64-step
    chunk), what ``SSDScanFunction``'s forward launches.

    A launch made through the dispatcher is one that a
    ``TorchDispatchMode`` sees: ``models.layers.remat``'s "dots" policy
    keeps this operator's outputs, so the checkpointed layer's recompute
    does not launch K5 again (the reference's ``checkpoint_dots`` keeps
    ``ssd_chunked``'s einsums), and under "full" the recompute launches
    it once more."""
    return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                         return_states=True)


@ssd_scan_op.register_fake
def _(x, dt, A, Bm, Cm, h0, chunk):
    # A meta tensor's kernel: the wrapper's meta branch (the launch's
    # checks, the work handed to the dry run's counter).
    return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                         return_states=True)


class SSDScanFunction(torch.autograd.Function):
    """K5 with K5-bwd as its backward: what ``ops.ssd_scan`` runs on CUDA
    tensors when a gradient is wanted.

    The forward launches K5 (``ssd_scan_op``) and keeps its inputs and
    the state entering each 64-step chunk (12.6 M floats, 50.3 MB, a layer
    at B=4, S=1024, H=24, P=64, N=128); the backward launches K5-bwd from
    them (``ssd_scan_bwd_cuda``).  An unused ``h_last`` (a training
    forward on one device) seeds the backward with nothing; a used one (a
    sequence-parallel shard's, which later shards read through the
    ladder) passes its gradient as ``g_hlast``.  With ``h0`` None (every
    shard but the first) no ``gh0`` is computed.
    ``apply(x, dt, A, Bm, Cm, h0, chunk)`` returns (y, h_last)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0, chunk):
        y, h_last, states = ssd_scan_op(x, dt, A, Bm, Cm, h0, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, g_hlast):
        x, dt, A, Bm, Cm, h0, states = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        gx, gdt, gA, gBm, gCm, gh0 = ssd_scan_bwd_cuda(
            x, dt, A, Bm, Cm, gy, states=states, chunk=ctx.chunk, h0=h0,
            g_hlast=g_hlast)
        return gx, gdt, gA, gBm, gCm, gh0, None
