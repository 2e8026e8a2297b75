"""Exact 3-nearest neighbours: each point's three nearest other points and
the mean of their squared distances, for FSGS's proximity densification and
the scale init of `create_from_pcd`.

Counterpart of `knn3` and `dist2_for_scale_init` in
`sparse_view_3dgs_pack_tpu/ops/knn.py` (reference `simple-knn`, its FSGS
variant returning indices, `FSGS/submodules/simple-knn/spatial.cu:15-26`).
The JAX `knn3` is a windowed-Morton approximation; the port is exact on
both routes:
  knn3  csrc/knn.cu (Morton-sorted leaves of 32 points under parents of 32
        leaves, culled a warp of queries at a time) | knn3_torch
The wrapper dispatches on the device of its tensor: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version. Neighbours are
ordered by (squared distance, index); a point is never its own neighbour,
an exact duplicate is one at distance 0. Both routes compute a squared
distance from the coordinate differences, dx·dx + dy·dy + dz·dz rounded
step by step in that order (not the cancelling |x|² + |y|² - 2x·y of a
matmul), and the mean as (d0 + d1 + d2) / 3, so that they agree bit for
bit. `knn3.launches` counts calls that launched the kernel;
`knn3.listed` holds, on the card, how many queries of the last such call
needed more than `BUDGET` leaves and were finished by a block each.
`morton_codes_torch` and `tree_boxes_torch` are the plain versions of the
kernel's codes and boxes; `knn3_work` runs the kernel with its work
counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import load

K = 3
LEAF = 32   # consecutive Morton-sorted points per leaf (kLeaf in knn.cu)
FAN = 32    # leaves per parent (kFan)
# leaves a query may need in its warp before it is listed and finished by a
# block of its own
BUDGET = 32
CELLS = 2097151.0   # Morton cells per axis less one (kCells)
WARP_COUNTS, LIST_COUNTS = 6, 3   # knn3_work's counts (kWarpCounts, ...)
# (chunk rows × N) squared distances of the plain version at a time
KNN_MAX_ELEMS = 1 << 27


def _sqdist(q: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(m, 3), (n, 3) → (m, n): dx·dx + dy·dy + dz·dz, q minus point."""
    dx = q[:, 0, None] - pts[None, :, 0]
    dy = q[:, 1, None] - pts[None, :, 1]
    dz = q[:, 2, None] - pts[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _check(points: torch.Tensor) -> None:
    if points.dtype != torch.float32 or points.ndim != 2 \
            or points.shape[1] != 3:
        raise ValueError(f"points: expected float32 (N, 3), got "
                         f"{points.dtype} {tuple(points.shape)}")
    if points.shape[0] <= K:
        raise ValueError(f"knn3 needs more than {K} points, got "
                         f"{points.shape[0]}")


def knn3(points: torch.Tensor):
    """(N, 3) float32, N > 3 → (mean squared distance to the 3 nearest
    other points (N,) float32, their indices (N, 3) int32, nearest first).
    CUDA tensors launch `csrc/knn.cu`; CPU tensors run `knn3_torch`."""
    _check(points)
    if points.device.type == "cuda":
        return _knn3_cuda(points)[:2]
    if points.device.type != "cpu":
        raise ValueError(f"no knn3 for device {points.device}")
    return knn3_torch(points)


knn3.launches = 0
knn3.listed = None


def knn3_torch(points: torch.Tensor):
    """Plain version: each chunk of query points against every point, the
    point itself masked out, three rounds of (min, first index of the min)
    so that ties go to the lower index."""
    _check(points)
    pts = points.contiguous()
    n = pts.shape[0]
    mean = torch.empty(n, dtype=torch.float32, device=pts.device)
    idx = torch.empty((n, K), dtype=torch.int32, device=pts.device)
    chunk = max(1, KNN_MAX_ELEMS // n)
    for s in range(0, n, chunk):
        d2 = _sqdist(pts[s:s + chunk], pts)
        rows = torch.arange(d2.shape[0], device=pts.device)
        d2[rows, rows + s] = float("inf")
        vals = []
        for j in range(K):
            i = torch.argmin(d2, dim=1)
            vals.append(d2[rows, i])
            idx[s:s + chunk, j] = i.to(torch.int32)
            d2[rows, i] = float("inf")
        total = vals[0] + vals[1] + vals[2]
        # a divisor tensor: PyTorch's CUDA division by a Python number
        # multiplies by its reciprocal, which rounds differently
        mean[s:s + chunk] = total / torch.full_like(total, 3.0)
    return mean, idx


def morton_codes_torch(points: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's codes: (N, 3) float32 → (N,) int64
    Morton codes, 21 bits per axis over the cloud's bounding box, x in the
    lowest bit."""
    lo, hi = points.amin(0), points.amax(0)
    ext = hi - lo
    q = torch.where(ext > 0, (points - lo) / ext * CELLS,
                    torch.zeros_like(points))
    cells = q.clamp(0.0, CELLS).to(torch.int64)
    code = torch.zeros(points.shape[0], dtype=torch.int64,
                       device=points.device)
    for d in range(3):
        x = cells[:, d] & 0x1fffff
        for shift, mask in ((32, 0x1f00000000ffff), (16, 0x1f0000ff0000ff),
                            (8, 0x100f00f00f00f00f), (4, 0x10c30c30c30c30c3),
                            (2, 0x1249249249249249)):
            x = (x | (x << shift)) & mask
        code |= x << d
    return code


class TreeBoxes(NamedTuple):
    """Boxes of consecutive runs of sorted points: (M, 3) float32 corners,
    (M,) int64 least original index and member count."""
    lo: torch.Tensor
    hi: torch.Tensor
    least: torch.Tensor
    count: torch.Tensor


def tree_boxes_torch(points: torch.Tensor, order: torch.Tensor):
    """Plain version of the kernel's boxes: the points in sorted `order`
    cut into leaves of LEAF and parents of FAN leaves → (leaves, parents),
    each a `TreeBoxes`."""
    n = points.shape[0]
    srt = points[order]

    def runs(lo, hi, least, count, size):
        m = -(-lo.shape[0] // size)
        extra = m * size - lo.shape[0]
        lo = torch.cat([lo, lo.new_full((extra, 3), float("inf"))])
        hi = torch.cat([hi, hi.new_full((extra, 3), float("-inf"))])
        least = torch.cat([least, least.new_full((extra,), n)])
        count = torch.cat([count, count.new_zeros(extra)])
        return TreeBoxes(lo.view(m, size, 3).amin(1),
                         hi.view(m, size, 3).amax(1),
                         least.view(m, size).amin(1),
                         count.view(m, size).sum(1))

    leaves = runs(srt, srt, order.to(torch.int64),
                  torch.ones(n, dtype=torch.int64, device=points.device),
                  LEAF)
    return leaves, runs(*leaves, FAN)


def _lib():
    """The kernel's library with its C signatures."""
    lib = load("knn")
    if not getattr(lib, "knn3_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.knn3_layout.argtypes = [ci, ctypes.POINTER(ctypes.c_size_t)]
        lib.knn3_layout.restype = None
        lib.knn3_codes.argtypes = [vp, vp, ci, vp]
        lib.knn3_codes.restype = ci
        lib.knn3_search.argtypes = [vp] * 5 + [ci, ci, vp, vp]
        lib.knn3_search.restype = ci
        lib.knn3_typed = True
    return lib


def _layout(lib, n: int) -> list:
    """Byte offsets of the scratch parts (codes, sorted, leaves, parents,
    counters, list, partial boxes) and the bytes in all."""
    out = (ctypes.c_size_t * 8)()
    lib.knn3_layout(n, out)
    return list(out)


def _knn3_cuda(points: torch.Tensor, stats=None):
    """The kernel's chain: codes, torch.sort, search, with `BUDGET` as it
    stands at the call. Returns (mean, idx, scratch, layout, order)."""
    pts = points.contiguous()
    n, dev = pts.shape[0], pts.device
    lib = _lib()
    at = _layout(lib, n)
    scratch = torch.empty(at[7], dtype=torch.uint8, device=dev)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty((n, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn3_codes(pts.data_ptr(), scratch.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"knn3_codes launch failed: cudaError {err}")
        codes = scratch[at[0]:at[0] + 8 * n].view(torch.int64)
        order = torch.sort(codes, stable=True).indices
        err = lib.knn3_search(pts.data_ptr(), order.data_ptr(),
                              scratch.data_ptr(), mean.data_ptr(),
                              idx.data_ptr(), n, BUDGET,
                              0 if stats is None else stats.data_ptr(),
                              stream)
    if err != 0:
        raise RuntimeError(f"knn3_search launch failed: cudaError {err}")
    knn3.launches += 1
    knn3.listed = scratch[at[4] + 4:at[4] + 8].view(torch.int32)
    return mean, idx, scratch, at, order


def knn3_work(points: torch.Tensor) -> dict:
    """The kernel on CUDA `points` (N, 3) float32 with its work counted:
    `warp` (ceil(N / LEAF), 6) int32, per warp of queries its box tests,
    boxes that passed them, leaves scanned (its own included), distance
    evaluations summed over its lanes, lanes listed and clock cycles /
    1024; `listed` (M, 3), per listed query its block's leaf tests,
    distance evaluations and cycles / 1024; the kernel's `codes` (N,)
    int64, `order` (their stable sort), `leaves` and `parents` ((M, 2, 4)
    float32: lo with the least index's bits, hi with the count's) and the
    result (`mean`, `idx`)."""
    _check(points)
    if points.device.type != "cuda":
        raise ValueError(f"knn3_work runs the kernel: CUDA points, got "
                         f"{points.device}")
    n = points.shape[0]
    n_leaves = -(-n // LEAF)
    stats = torch.zeros(WARP_COUNTS * n_leaves + LIST_COUNTS * n,
                        dtype=torch.int32, device=points.device)
    mean, idx, scratch, at, order = _knn3_cuda(points, stats)
    listed = int(knn3.listed)
    n_parents = -(-n_leaves // FAN)
    return dict(
        warp=stats[:WARP_COUNTS * n_leaves].view(n_leaves, WARP_COUNTS),
        listed=stats[WARP_COUNTS * n_leaves:][:LIST_COUNTS * listed]
        .view(listed, LIST_COUNTS),
        codes=scratch[at[0]:at[0] + 8 * n].view(torch.int64), order=order,
        leaves=scratch[at[2]:at[2] + 32 * n_leaves].view(torch.float32)
        .view(n_leaves, 2, 4),
        parents=scratch[at[3]:at[3] + 32 * n_parents].view(torch.float32)
        .view(n_parents, 2, 4),
        mean=mean, idx=idx)


def dist2_for_scale_init(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) float32 → (N,) clamp_min(mean of the 3 smallest squared
    distances to other points, 1e-7), through `knn3` (a cloud of at most 3
    points averages the distances it has)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    if n > K:
        return torch.clamp(knn3(pts)[0], min=1e-7)
    if n <= 1:
        return torch.full((n,), 1e-7, device=pts.device)
    d2 = _sqdist(pts, pts)
    d2.fill_diagonal_(float("inf"))
    return torch.clamp(torch.topk(d2, n - 1, dim=1, largest=False)
                       .values.mean(1), min=1e-7)
