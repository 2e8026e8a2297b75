"""Mean squared distance to the 3 nearest neighbours, for the scale init of
`create_from_pcd`.

Counterpart of `dist2_for_scale_init` in `sparse_view_3dgs_pack_tpu/ops/
knn.py` (reference `simple-knn`). The JAX package searches exactly only
through its optional native extension and otherwise takes a windowed-Morton
approximation; the port searches exactly, on the points' own device: each
chunk of query points against every point, squared distances summed from
the coordinate differences (not the cancelling |x|² + |y|² - 2x·y of a
matmul), the point itself masked out, the three smallest kept.
"""

from __future__ import annotations

import torch

# (chunk rows × N × 3) coordinate differences at a time
KNN_MAX_ELEMS = 1 << 27


def dist2_for_scale_init(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(N, 3) float32 → (N,) clamp_min(mean of the k smallest squared
    distances to other points, 1e-7)."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    kk = min(k, n - 1)
    if kk <= 0:
        return out.fill_(1e-7)
    chunk = max(1, KNN_MAX_ELEMS // (3 * n))
    for s in range(0, n, chunk):
        q = pts[s:s + chunk]
        d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + s] = float("inf")
        out[s:s + chunk] = torch.topk(d2, kk, dim=1,
                                      largest=False).values.mean(1)
    return torch.clamp(out, min=1e-7)
