"""Fused k-means assignment + per-centre statistics (the paper's k-means hot loop).

The counterpart of the TPU kernel ``repro/kernels/kmeans_assign.py::
kmeans_assign``.  One pass over the points does all the assignment step needs:

    d²  = ‖c‖² − 2 x·cᵀ         (‖x‖² dropped: it does not move the argmin)
    a   = argmin_k d²            (the first index on ties)
    out[K, D+1] = Σ over the points assigned to each centre of [x | 1]

On a CUDA tensor :func:`kmeans_assign` launches the hand-written kernel in
``csrc/kmeans_assign.cu`` (the source says how it is built and why); on a CPU
tensor it runs :func:`kmeans_assign_plain`, the same function in plain
PyTorch.  :func:`near_ties` marks the points whose nearest centre f32
rounding may decide, where two correct versions may disagree.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

THREADS = 256  # a CTA of the shared and global forms
# The stream form, for K <= STREAM_K and D <= STREAM_D (one compiled instance
# each): STREAM_WARPS consumer warps a CTA take 4 points a thread, TILE
# points a tile, and one producer warp streams the tiles in; a persistent
# grid of STREAM_CTAS_PER_SM CTAs an SM.
STREAM_K, STREAM_D = 8, 4
STREAM_WARPS = 8
TILE = 4 * 32 * STREAM_WARPS
STREAM_CTAS_PER_SM = 1
# Largest shared working set (centres, their norms and the [K, D+1]
# accumulator) a CTA of the shared form takes: what a launch may use
# without opting in.
SHARED_BYTES = 48 * 1024
FORMS = ("stream", "shared", "global")
F32_U = 2.0 ** -24  # unit roundoff of float32


def kmeans_assign_plain(points: torch.Tensor, centers: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of exactly what the kernel computes:
    ``(assign [N] int32, stats [K, D+1] f32)``.

    ``Σx`` and the counts accumulate in float64 and round to f32 once: a
    running f32 sum stops growing once it passes 2^24 times its addends'
    size, so at 10^8 points an f32 scatter-add is no yardstick for the kernel.
    """
    cn = (centers * centers).sum(1)
    assign = torch.argmin(cn[None, :] - 2.0 * (points @ centers.T), dim=1)
    k, d = centers.shape
    ones = torch.ones((points.shape[0], 1), dtype=torch.float64, device=points.device)
    stats = torch.zeros((k, d + 1), dtype=torch.float64, device=points.device)
    stats.index_add_(0, assign, torch.cat([points.double(), ones], dim=1))
    return assign.to(torch.int32), stats.float()


def near_ties(points: torch.Tensor, centers: torch.Tensor, *,
              with_norm_x: bool = False, rows: int = 1 << 24) -> torch.Tensor:
    """Per point, True where f32 rounding may decide the nearest centre.

    The gap between the best and the second-best ``d² = ‖c‖² − 2x·c``
    (float64) is at most ``8·2^-24·(‖c‖² + 2 Σ_j |x_j c_j|)`` of either of
    the two centres: two versions that sum the D products in another order
    may then pick different centres.  ``with_norm_x`` adds ``‖x‖²`` to that
    scale, for a version that keeps it (``kmeans_assign_ref``).  Works on
    ``rows`` points at a time to bound the float64 scratch.
    """
    if centers.shape[0] < 2:
        return torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    c = centers.double()
    cn = (c * c).sum(1)
    out = []
    for start in range(0, points.shape[0], rows):
        x = points[start:start + rows].double()
        d2 = cn[None, :] - 2.0 * (x @ c.T)
        scale = cn[None, :] + 2.0 * (x.abs() @ c.abs().T)
        if with_norm_x:
            scale = scale + (x * x).sum(1, keepdim=True)
        two = torch.topk(d2, 2, dim=1, largest=False)
        margin = 8.0 * F32_U * scale.gather(1, two.indices).amax(1)
        out.append(two.values[:, 1] - two.values[:, 0] <= margin)
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=points.device)
    return torch.cat(out)


def launch_shape(n: int, d: int, k: int, device) -> tuple[str, int]:
    """``(form, blocks)`` of the kernel's launch: the ``"stream"`` form for
    K <= :data:`STREAM_K` and D <= :data:`STREAM_D`, a persistent grid of
    :data:`STREAM_CTAS_PER_SM` CTAs an SM (no more than there are whole
    tiles, at least one); else ``"shared"`` when the centres, their norms and
    the ``[K, D+1]`` accumulator fit :data:`SHARED_BYTES`, else ``"global"``,
    each a grid of ``blocks`` CTAs of :data:`THREADS` that strides over the
    points (point ``i`` goes to thread ``i % (blocks * THREADS)``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if k <= STREAM_K and d <= STREAM_D:
        return "stream", max(1, min(sms * STREAM_CTAS_PER_SM, n // TILE))
    if k * (2 * d + 2) * 4 <= SHARED_BYTES:
        form, per_sm = "shared", 4
    else:
        form, per_sm = "global", 8
    return form, min(-(-n // THREADS), sms * per_sm)


def stream_layout(n: int, d: int, offset: int) -> tuple[int, int, int]:
    """``(head, shift, tiles)``: how the stream form cuts ``n`` points of
    ``d`` floats that start ``offset`` floats past a 16-byte boundary.

    A bulk copy needs a 16-byte-aligned source.  ``head`` (at most 3) is the
    fewest points after which a point starts on 16 bytes, and ``shift`` is
    0; where no point does (``d`` = 2 or 4 and an odd start), ``head`` is
    the fewest points after which the 16 bytes below the next point lie in
    the input, and ``shift`` is that point's offset in floats from them.
    ``tiles`` is the count of whole :data:`TILE`-point tiles after the head
    whose copy (``shift``: 16 bytes longer) stays inside the input.  The
    points outside the tiles (``n − tiles·TILE``: the head, then the tail)
    are read with plain loads; with no tile, ``head`` and ``shift`` are 0."""
    o = offset % 4
    head = next((h for h in range(4) if (o + h * d) % 4 == 0), None)
    if head is None:
        head = next(h for h in range(4) if (o + h * d) // 4 * 4 >= o)
    shift = (o + head * d) % 4
    tiles = max(n - head, 0) // TILE
    if tiles and shift and (n - head - tiles * TILE) * d < 4 - shift:
        tiles -= 1
    return (head, shift, tiles) if tiles else (0, 0, 0)


def stream_threads(n: int, d: int, offset: int, blocks: int, device=None) -> torch.Tensor:
    """Per point ``[n]`` int64: the stream form's consumer thread that reads
    it and adds it into its sums, ``cta · 32·STREAM_WARPS + t``.  Tile ``j``
    goes to CTA ``j mod blocks``, its points ``4t..4t+3`` to thread ``t``;
    the head and tail, in order, to the threads of CTA ``tiles mod blocks``
    round robin."""
    head, _, tiles = stream_layout(n, d, offset)
    lanes = 32 * STREAM_WARPS
    i = torch.arange(n, device=device)
    local = i - head
    in_tile = (local >= 0) & (local < tiles * TILE)
    extra = torch.where(i < head, i, i - tiles * TILE)
    cta = torch.where(in_tile, torch.div(local, TILE, rounding_mode="floor") % blocks,
                      tiles % blocks)
    return cta * lanes + torch.where(in_tile, local % TILE // 4, extra % lanes)


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor, *,
                  block_n: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``(assign [N] int32, stats [K, D+1] = [Σx | count] f32)`` of ``points
    [N, D]`` against ``centers [K, D]``, both f32 and contiguous; the kernel
    on a CUDA tensor, the plain version on a CPU tensor.

    ``block_n`` keeps the TPU kernel's signature; the CUDA kernel picks its
    own tile (:data:`TILE` points in the stream form).
    """
    del block_n
    if points.dim() != 2 or centers.dim() != 2 or points.shape[1] != centers.shape[1]:
        raise ValueError(f"need points [N, D] and centers [K, D], got "
                         f"{tuple(points.shape)} and {tuple(centers.shape)}")
    k, d = centers.shape
    if k == 0 or d == 0:
        raise ValueError(f"need K > 0 centres of D > 0 dims, got [{k}, {d}]")
    if points.device.type == "cpu" and centers.device.type == "cpu":
        return kmeans_assign_plain(points, centers)
    if points.device != centers.device or points.device.type != "cuda":
        raise ValueError(f"points on {points.device}, centers on {centers.device}: "
                         "need both on one CUDA device (or both on the CPU)")
    if points.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"need f32 points and centers, got {points.dtype} and "
                        f"{centers.dtype}")
    if not (points.is_contiguous() and centers.is_contiguous()):
        raise ValueError("points and centers must be contiguous")
    n = points.shape[0]
    dev = points.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:  # a 0-block grid is a launch error
        return assign, torch.zeros((k, d + 1), dtype=torch.float32, device=dev)
    form, blocks = launch_shape(n, d, k, dev)
    if form == "stream":  # the kernel writes every cell of stats
        stats = torch.empty((k, d + 1), dtype=torch.float32, device=dev)
        scratch = torch.empty((blocks, k * (d + 1)), dtype=torch.float32, device=dev)
        head, shift, tiles = stream_layout(n, d, points.data_ptr() // 4)
    else:
        stats = torch.zeros((k, d + 1), dtype=torch.float32, device=dev)
        scratch, (head, shift, tiles) = None, (0, 0, 0)
    with torch.cuda.device(dev):
        err = _kernel()(points.data_ptr(), centers.data_ptr(), assign.data_ptr(),
                        stats.data_ptr(), None if scratch is None else scratch.data_ptr(),
                        n, d, k, FORMS.index(form), blocks, THREADS, head, shift, tiles,
                        _build.raw_stream(dev.index))
    _build.check(err, "kmeans_assign")
    kmeans_assign.launches += 1
    return assign, stats


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.entry("kmeans_assign", "blaze_kmeans_assign", [
        vp, vp, vp, vp, vp, ctypes.c_longlong, *[i32] * 7, ctypes.c_longlong, vp,
    ])


kmeans_assign.launches = 0  # kernel launches since the caller last reset it
