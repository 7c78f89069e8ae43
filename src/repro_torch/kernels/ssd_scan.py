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
for a CPU tensor.  ``ssd_scan_cuda.launches`` counts calls that launched
the kernel (two CUDA launches each: the state scan and the chunk scan).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.specs import SMEM_LIMIT_BYTES

KERNEL_CHUNK = 64               # steps of one chunk inside the kernel
_GRID_LIMIT = 65535             # CUDA's cap on grid dims y and z


def segsum_decay(a_cum: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(a_cum_i - a_cum_j) for j <= i else 0.  a_cum: (..., Q)."""
    q = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=a_cum.device))
    return torch.where(tri, torch.exp(diff), 0.0)


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


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """The SSD scan; (y (B, S, H, P), h_last (B, H, N, P)) fp32.

    Args:
      x: (B, S, H, P) float32 values, (H, P) dense.
      dt: (B, S, H) float32 positive step sizes, H dense.
      A: (H,) float32 negative decay rates.
      Bm, Cm: (B, S, 1, N) float32, N dense (G = 1 only on the card).
      chunk: S must be a multiple of it, as for the reference kernel.
      h0: optional (B, H, N, P) contiguous float32 initial state.

    A CPU tensor runs ``ssd_scan_plain``; a CUDA tensor launches K5 or
    raises.
    """
    check_inputs(x, dt, A, Bm, Cm, chunk, h0)
    _check_kernel_inputs(x, dt, Bm, Cm, h0)
    if not x.is_cuda:
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    A = A.contiguous()
    # The kernel copies 16-byte pieces of x, B, C and h0: a view that does
    # not start (or step) on 16 bytes is copied first.
    x, Bm, Cm = (t if _aligned16(t) else t.clone() for t in (x, Bm, Cm))
    if h0 is not None and not _aligned16(h0):
        h0 = h0.clone()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    # Scratch: the state entering each 64-step chunk.
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
    return y, h_last


ssd_scan_cuda.launches = 0
