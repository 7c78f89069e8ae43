"""Multi-GPU integral histograms: the paper's §4.6 scheme over a mesh.

Port of ``repro/core/distributed.py``.  Paper §4.6 groups the bins into
tasks and hands them to 4 GPUs through a task queue, with no peer
communication.  The reference lays that out with ``shard_map``; here one
process drives every device of a ``device.Mesh`` with plain calls on
per-shard tensors.  Kernel launches return before the card finishes, so
the shards of a mesh over several cards overlap without threads.  A mesh
may name one card several times (logical shards): every path below then
runs, with the real kernels, on that card.

  * **Bin sharding** (``bin_sharded_ih``) — the paper's scheme: every
    shard bins the (replicated) frame on its device and runs K1 (K4 for
    ``method="cw_tis"``) over its own bin range.  Nothing crosses shards
    after the frame is placed.
  * **Spatial sharding** (``spatial_sharded_ih``) — row strips over
    ``row_axis``, optionally bin-sharded on top.  Each strip's bottom row
    (its per-column counts, summed across the columns) is counted from its
    ids first, an exclusive scan down the strips (``exclusive_axis_scan``)
    gives each strip the bottom row of everything above it, and each
    strip's single K1 launch starts from that carry: H is written once.
    The reference adds the prefix to a finished local H instead, a second
    pass over all of H.
  * **Band streaming** (``iter_banded_sharded_ih``) — either sharding
    under a memory budget (core/bands.py): the band carry rides into the
    kernels' carry-in next to the strips' prefixes.

Every shard of a mapping over some mesh axes computes once, at index 0 of
the other axes (``Mesh.grid``); the reference's ``shard_map`` computes the
same shard again on each of them.  Results are lists of per-shard tensors;
``hsource.ShardedH`` wraps them as an H.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.binning import bin_indices
from repro_torch.core.hsource import ShardedH
from repro_torch.core.runtime import MeshPlacement, Placed
from repro_torch.device import Mesh
from repro_torch.kernels.ops import integral_histogram

SHARDINGS = ("bin", "spatial")


def exclusive_axis_scan(xs, impl: str = "allgather") -> list:
    """Exclusive prefix sum over shards: shard ``i`` receives the sum of
    ``xs[:i]`` on its own device (``xs`` is one tensor a shard, in axis
    order).

    ``"allgather"`` gathers every value onto each shard and takes a
    masked sum; ``"ppermute"`` is the log2(D) Hillis–Steele ladder of
    shifted copies, the literal wavefront.  The values are integer counts
    below 2**24 in fp32, so both orders of addition give the same bits."""
    d = len(xs)
    if impl == "allgather":
        out = []
        for i, x in enumerate(xs):
            gathered = torch.stack([v.to(x.device) for v in xs])
            mask = (torch.arange(d, device=x.device) < i).to(x.dtype)
            out.append((mask.reshape((d,) + (1,) * x.ndim) * gathered)
                       .sum(0))
        return out
    if impl == "ppermute":
        val = [xs[i - 1].to(x.device) if i else torch.zeros_like(x)
               for i, x in enumerate(xs)]
        step = 1
        while step < d:
            val = [v + val[i - step].to(v.device) if i >= step else v
                   for i, v in enumerate(val)]
            step *= 2
        return val
    raise ValueError(f"unknown impl {impl!r}")


def _placement(mesh: Mesh, row_axis, bin_axis) -> MeshPlacement:
    """Row strips over ``row_axis`` (one strip if None) x bin shards over
    ``bin_axis`` (one if None)."""
    axes = tuple(a for a in (row_axis, bin_axis) if a is not None)
    grid = mesh.grid(axes)
    return MeshPlacement(grid.reshape(
        (grid.shape[0] if row_axis is not None else 1, -1)))


def band_input_sharding(mesh: Mesh, sharding: str, *,
                        row_axis: str = "data",
                        bin_axis: str = "model") -> MeshPlacement:
    """How a frame or band slice is staged before the sharded compute
    reads it: replicated over the ``bin_axis`` shards for bin sharding
    (one copy per distinct device), row strips over ``row_axis`` for
    spatial sharding.  Hand it to ``FrameRuntime``/``stage_stream``/
    ``bands.iter_banded_ih`` as ``device=``."""
    if sharding == "bin":
        return _placement(mesh, None, bin_axis)
    if sharding == "spatial":
        return _placement(mesh, row_axis, None)
    raise ValueError(f"unknown sharding {sharding!r} (bin|spatial)")


def replica_meshes(mesh: Mesh, replica_axis: str) -> list:
    """Split a mesh into frame-parallel replica groups along
    ``replica_axis``: one ``Mesh`` over the remaining axes a group, or
    ``None`` for a group that is one bare device (a 1-D mesh; callers
    hand it a plain single-device engine).  A mesh without the axis is
    one group: ``[mesh]``."""
    names = list(mesh.axis_names)
    if replica_axis not in names:
        return [mesh]
    ax = names.index(replica_axis)
    rest = tuple(names[:ax] + names[ax + 1:])
    return [Mesh(np.take(mesh.devices, i, axis=ax), rest) if rest else None
            for i in range(mesh.shape[replica_axis])]


def _local_ids(img: torch.Tensor, num_bins: int, value_range, lo: int,
               local_bins: int) -> torch.Tensor:
    """Bin ids of ``img`` shifted to the shard's range ``[lo, lo +
    local_bins)``: every kernel and plain scan counts an id outside
    ``[0, local_bins)`` in no bin, so no masking is needed."""
    idx = bin_indices(img, num_bins, value_range)
    return idx - lo if lo else idx


def _bottom_row(ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(h, w) ids -> (num_bins, w) fp32: the bottom row of their H, each
    bin's count in columns ``[0, c]``.  One exact scatter-add over the ids
    counts each column, a cumsum across the columns sums them; ids outside
    ``[0, num_bins)`` count nowhere."""
    w = ids.shape[-1]
    col = torch.arange(w, dtype=ids.dtype, device=ids.device)
    valid = (ids >= 0) & (ids < num_bins)
    key = torch.where(valid, ids * w + col, num_bins * w).reshape(-1)
    out = torch.zeros(num_bins * w + 1, dtype=torch.float32,
                      device=ids.device)
    out.index_add_(0, key, torch.ones(1, device=ids.device).expand(
        key.numel()))
    return out[:-1].reshape(num_bins, w).cumsum(-1)


def _split_bins(num_bins: int, shards: int) -> int:
    if num_bins % shards:
        raise ValueError(f"{num_bins} bins not divisible by {shards} shards")
    return num_bins // shards


def bin_sharded_ih(image, num_bins: int, mesh: Mesh, *,
                   bin_axis: str = "model", method: str = "wf_tis",
                   backend: str = "auto", value_range: int | None = 256,
                   carry_in=None) -> list:
    """The paper's multi-GPU scheme: bins sharded over ``bin_axis``.

    ``image`` is an (h, w) frame or an (n, h, w) stack (one launch a
    shard), or a ``Placed`` from ``band_input_sharding(mesh, "bin")``.
    ``carry_in`` is ``None`` or one ``([n,] local_bins, w)`` carry a shard
    (a band stream's).  Returns one ``([n,] num_bins / D, h, w)`` H a
    shard, bins ascending, each on its shard's device."""
    placement = band_input_sharding(mesh, "bin", bin_axis=bin_axis)
    devs = placement.grid[0]
    local = _split_bins(num_bins, len(devs))
    placed = image if isinstance(image, Placed) else placement.place(image)
    return [
        integral_histogram(
            _local_ids(placed[(0, dev)], num_bins, value_range, j * local,
                       local),
            local, method=method, backend=backend, value_range=None,
            carry_in=None if carry_in is None else carry_in[j], device=dev)
        for j, dev in enumerate(devs)]


def spatial_sharded_ih(image, num_bins: int, mesh: Mesh, *,
                       row_axis: str = "data", bin_axis: str | None = None,
                       method: str = "wf_tis", backend: str = "auto",
                       value_range: int | None = 256,
                       scan_impl: str = "allgather", carry_in=None) -> list:
    """Row strips over ``row_axis`` (+ optional bin sharding over
    ``bin_axis``) of one (h, w) frame, or of a ``Placed`` from
    ``band_input_sharding(mesh, "spatial")``.

    Carry first: each strip's bottom row (its ids, counted once), an
    exclusive scan of them down the strips, then one K1 launch a strip
    seeded with the counts above it (plus ``carry_in``, one ``(local_bins,
    w)`` band carry a bin shard).  Returns ``H[r][j]``: strip ``r``'s rows
    of bin shard ``j``, on that shard's device."""
    placement = _placement(mesh, row_axis, bin_axis)
    grid = placement.grid
    rows, shards = grid.shape
    local = _split_bins(num_bins, shards)
    if not isinstance(image, Placed):
        if np.ndim(image) != 2:
            raise ValueError(
                "spatial sharding is single-frame: (h, w), got shape "
                f"{tuple(np.shape(image))}")
        image = placement.place(image)
    ids = [[_local_ids(image[(r, grid[r, j])], num_bins, value_range,
                       j * local, local) for j in range(shards)]
           for r in range(rows)]
    out = [[None] * shards for _ in range(rows)]
    for j in range(shards):
        prefix = exclusive_axis_scan(
            [_bottom_row(ids[r][j], local) for r in range(rows)],
            scan_impl)
        for r in range(rows):
            dev = grid[r, j]
            carry = prefix[r]
            if carry_in is not None:
                carry = carry + carry_in[j].to(dev)
            out[r][j] = integral_histogram(
                ids[r][j], local, method=method, backend=backend,
                value_range=None, carry_in=carry, device=dev)
    return out


def iter_banded_sharded_ih(image, num_bins: int, mesh: Mesh, *,
                           sharding: str = "bin", band_h: int | None = None,
                           memory_budget_bytes: int | None = None,
                           bin_axis: str = "model", row_axis: str = "data",
                           method: str = "wf_tis", backend: str = "auto",
                           value_range: int | None = 256,
                           scan_impl: str = "allgather", prefetch: int = 0):
    """Band streaming composed with either sharding: each band runs bin-
    or spatially sharded, and the band carry (one bottom row a bin shard)
    seeds the next band's kernels.  ``"bin"`` takes (h, w) or (n, h, w);
    ``"spatial"`` is single-frame and rounds the band height to the
    row-shard count.  Yields ``BandH`` chunks whose ``H`` is a
    ``ShardedH`` and whose ``carry`` is that list of bottom rows.  Band
    slices are staged with ``band_input_sharding``'s placement when
    ``prefetch >= 1``, as the single-device stream stages its slices."""
    from repro_torch.core import bands

    if sharding not in SHARDINGS:
        raise ValueError(f"unknown sharding {sharding!r} (bin|spatial)")
    h, w = image.shape[-2:]
    row_multiple = 1
    if sharding == "spatial":
        if image.ndim != 2:
            raise ValueError("spatial banding is single-frame: (h, w)")
        row_multiple = mesh.shape[row_axis]
        if h % row_multiple:
            raise ValueError(
                f"height {h} not divisible by {row_multiple} row shards")
    num_frames = 1 if image.ndim == 2 else image.shape[0]
    plan = bands.plan_bands(
        h, w, num_bins, band_h=band_h,
        memory_budget_bytes=memory_budget_bytes, num_frames=num_frames,
        row_multiple=row_multiple)
    kw = dict(method=method, backend=backend, value_range=value_range)

    def compute_fn(band_img, carry_in):
        if sharding == "bin":
            shards = bin_sharded_ih(band_img, num_bins, mesh,
                                    bin_axis=bin_axis, carry_in=carry_in,
                                    **kw)
        else:
            shards = spatial_sharded_ih(band_img, num_bins, mesh,
                                        row_axis=row_axis,
                                        scan_impl=scan_impl,
                                        carry_in=carry_in, **kw)
        return ShardedH(shards, mesh, kind=sharding)

    staging = band_input_sharding(mesh, sharding, row_axis=row_axis,
                                  bin_axis=bin_axis)
    return bands.iter_banded_ih(image, num_bins, plan=plan,
                                compute_fn=compute_fn, device=staging,
                                prefetch=prefetch)


def distributed_region_query(H_sharded, rects, mesh: Mesh) -> torch.Tensor:
    """Region queries against a bin-sharded H (``bin_sharded_ih``'s
    list): each shard answers for its bins and the results concatenate
    over bins, on the first shard's device.  Rank-polymorphic like
    ``region_histogram``: (*H_lead, *rects_lead, b)."""
    return ShardedH(H_sharded, mesh, kind="bin").region_histogram(rects)
