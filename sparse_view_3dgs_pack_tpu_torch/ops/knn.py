"""Exact 3-nearest neighbours: each point's three nearest other points and
the mean of their squared distances, for FSGS's proximity densification and
the scale init of `create_from_pcd`.

Counterpart of `knn3` and `dist2_for_scale_init` in
`sparse_view_3dgs_pack_tpu/ops/knn.py` (reference `simple-knn`, its FSGS
variant returning indices, `FSGS/submodules/simple-knn/spatial.cu:15-26`).
The JAX `knn3` is a windowed-Morton approximation; the port is exact on
both routes:
  knn3  csrc/knn.cu (Morton-sorted boxes with AABB pruning) | knn3_torch
The wrapper dispatches on the device of its tensor: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version. Neighbours are
ordered by (squared distance, index); a point is never its own neighbour,
an exact duplicate is one at distance 0. Both routes compute a squared
distance from the coordinate differences, dx·dx + dy·dy + dz·dz rounded
step by step in that order (not the cancelling |x|² + |y|² - 2x·y of a
matmul), and the mean as (d0 + d1 + d2) / 3, so that they agree bit for
bit. `knn3.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load

K = 3
BOX = 256   # consecutive Morton-sorted points per box (kBox in knn.cu)
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
        return _knn3_cuda(points)
    if points.device.type != "cpu":
        raise ValueError(f"no knn3 for device {points.device}")
    return knn3_torch(points)


knn3.launches = 0


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


def _knn3_cuda(points: torch.Tensor):
    pts = points.contiguous()
    n, dev = pts.shape[0], pts.device
    lib = load("knn")
    fn_morton = lib.knn_morton
    fn_morton.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                  ctypes.c_void_p]
    fn_morton.restype = ctypes.c_int
    fn_search = lib.knn3_search
    fn_search.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                  ctypes.c_void_p]
    fn_search.restype = ctypes.c_int
    bbox = torch.cat([pts.amin(0), pts.amax(0)]).contiguous()
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    n_boxes = -(-n // BOX)
    sorted_pts = torch.empty((n, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((n_boxes, 2, 4), dtype=torch.float32, device=dev)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty((n, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn_morton(pts.data_ptr(), bbox.data_ptr(), codes.data_ptr(), n,
                        stream)
        if err != 0:
            raise RuntimeError(f"knn_morton launch failed: cudaError {err}")
        order = torch.sort(codes, stable=True).indices.to(torch.int32)
        err = fn_search(pts.data_ptr(), order.data_ptr(),
                        sorted_pts.data_ptr(), boxes.data_ptr(),
                        mean.data_ptr(), idx.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"knn3_search launch failed: cudaError {err}")
    knn3.launches += 1
    return mean, idx


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
