"""Pseudo-view depth priors without an in-loop mono-depth network.

Counterpart of `sparse_view_3dgs_pack_tpu/depth/warp.py`. The reference
runs MiDaS on every rendered pseudo view (`FSGS/train.py:116-131`), which
needs weights an offline deployment may not hold. The substitute WARPS the
nearest training view's precomputed mono prior into the pseudo view:

1. the training view's relative prior is affine-aligned to metric inverse
   depth against that view's RENDERED inverse depth (least squares, the
   scale/offset model of `make_depth_scale.py:8-50`);
2. the metric depth is unprojected to world points and re-projected into
   the pseudo camera, where a z-buffer keeps the nearest surface per pixel
   (`scatter_reduce(..., "amin")`: min does not depend on the order of the
   scatter, so the result is deterministic);
3. the pseudo distillation step applies the Pearson loss on the covered
   pixels only.

Splat pixels are `torch.round`ed, half to even like `jnp.round`.
"""

from __future__ import annotations

import torch

from ..ops.projection import NEAR_CULL_Z, ndc2pix


def fit_inv_affine(prior: torch.Tensor, rendered_inv: torch.Tensor,
                   mask: torch.Tensor):
    """Least-squares (a, b): a·prior + b ≈ rendered_inv over mask."""
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mx = (prior * w).sum() / n
    my = (rendered_inv * w).sum() / n
    cov = ((prior - mx) * (rendered_inv - my) * w).sum() / n
    var = ((prior - mx) ** 2 * w).sum() / n
    a = cov / torch.clamp(var, min=1e-12)
    b = my - a * mx
    return a, b


def _mat(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


def warp_depth(z_src: torch.Tensor, src_valid: torch.Tensor, src_cam,
               dst_cam, width: int, height: int):
    """Forward-warp per-pixel metric depth z_src (H, W) from `src_cam` into
    `dst_cam` (`data.cameras.CameraParams`, arrays or tensors) → (warped z
    (H, W), valid (H, W) bool). Splat conflicts resolve to the nearest
    surface."""
    H, W = height, width
    dev = z_src.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    # invert ndc2pix(v, S) = ((v+1)·S − 1)/2 → ndc = (2·pix + 1)/S − 1
    ndc_x = (2.0 * u + 1.0) / W - 1.0
    ndc_y = (2.0 * v + 1.0) / H - 1.0
    z = z_src
    x_cam = ndc_x * float(src_cam.tan_fovx) * z
    y_cam = ndc_y * float(src_cam.tan_fovy) * z
    cam_pts = torch.stack([x_cam.expand(H, W), y_cam.expand(H, W),
                           z.expand(H, W), torch.ones((H, W), device=dev)],
                          dim=-1).reshape(-1, 4)
    world = cam_pts @ torch.linalg.inv(_mat(src_cam.viewmat, dev)).T

    p_hom = world @ _mat(dst_cam.full_proj, dev).T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :3] * p_w[:, None]
    px = ndc2pix(ndc[:, 0], W)
    py = ndc2pix(ndc[:, 1], H)
    # destination depth = z in the destination camera's frame
    z_dst = (world @ _mat(dst_cam.viewmat, dev).T)[:, 2]

    iu = torch.round(px).to(torch.int64)
    iv = torch.round(py).to(torch.int64)
    ok = (src_valid.reshape(-1) & (z_dst > NEAR_CULL_Z)
          & (iu >= 0) & (iu < W) & (iv >= 0) & (iv < H))
    flat = torch.where(ok, iv * W + iu, torch.full_like(iu, H * W))
    inf = torch.full((H * W + 1,), float("inf"), device=dev)
    zbuf = inf.scatter_reduce(
        0, flat, torch.where(ok, z_dst, torch.full_like(z_dst, float("inf"))),
        reduce="amin")[:H * W]
    valid = torch.isfinite(zbuf)
    return (torch.where(valid, zbuf, torch.zeros_like(zbuf)).reshape(H, W),
            valid.reshape(H, W))


def metric_depth_from_prior(prior: torch.Tensor,
                            rendered_invdepth: torch.Tensor,
                            rendered_alpha: torch.Tensor):
    """Affine-align a relative mono prior to the rendered inverse depth →
    (metric z (H, W), valid mask)."""
    mask = (rendered_alpha > 0.5) & (rendered_invdepth > 1e-6)
    a, b = fit_inv_affine(prior, rendered_invdepth, mask)
    inv = a * prior + b
    valid = mask & (inv > 1e-6)
    return 1.0 / torch.clamp(inv, min=1e-6), valid
