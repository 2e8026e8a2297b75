"""DNGaussian depth-normalisation losses.

Counterpart of `sparse_view_3dgs_pack_tpu/losses/dng.py` (reference
`DNGaussian/utils/loss_utils.py:18-103`). Depth maps are cut into
non-overlapping patches, each patch is standardised (local: its own std;
global: the whole map's, detached), and an L2 / L1 applies only where
|diff| exceeds the margin (`error_tolerance`), as a where-weighted mean.
"""

from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(H, W) or (H, W, 1) → (L, patch_size²), non-overlapping; the
    remainder rows and columns are dropped."""
    if x.ndim == 3:
        x = x[..., 0]
    H, W = x.shape
    ny, nx = H // patch_size, W // patch_size
    x = x[:ny * patch_size, :nx * patch_size]
    x = x.reshape(ny, patch_size, nx, patch_size)
    return x.permute(0, 2, 1, 3).reshape(ny * nx, patch_size * patch_size)


def _safe_std(sq_dev_mean: torch.Tensor) -> torch.Tensor:
    """sqrt(var + 1e-12): smooth and ≥ 1e-6 where a patch is constant,
    where sqrt(var) has a NaN gradient."""
    return torch.sqrt(sq_dev_mean + 1e-12)


def normalize_patches(p: torch.Tensor, std=None,
                      eps_scale: float = 1e-2) -> torch.Tensor:
    """Standardise each row (unbiased std, or `std` when given), with the
    reference's 1e-2·global-std added to the denominator."""
    n = p.shape[1]
    mean = p.mean(dim=1, keepdim=True)
    if std is None:
        var = ((p - mean) ** 2).sum(dim=1, keepdim=True) / (n - 1)
        row_std = _safe_std(var)
    else:
        row_std = std
    gmean = p.mean()
    gvar = ((p - gmean) ** 2).sum() / (p.numel() - 1)
    global_std = _safe_std(gvar)
    return (p - mean) / (row_std + eps_scale * global_std)


def margin_l2_loss(x, y, margin: float) -> torch.Tensor:
    d = x - y
    mask = (torch.abs(d) > margin).to(x.dtype)
    return (d * d * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def margin_l1_loss(x, y, margin: float) -> torch.Tensor:
    d = torch.abs(x - y)
    mask = (d > margin).to(x.dtype)
    return (d * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def patch_norm_mse_loss(pred, gt, patch_size: int,
                        margin: float) -> torch.Tensor:
    """The local variant: each patch standardised by its own std."""
    return margin_l2_loss(normalize_patches(patchify(pred, patch_size)),
                          normalize_patches(patchify(gt, patch_size)),
                          margin)


def patch_norm_mse_loss_global(pred, gt, patch_size: int,
                               margin: float) -> torch.Tensor:
    """The global variant: every patch standardised by the whole map's
    std, detached as in the reference."""
    ps = _safe_std(pred.reshape(-1).var(correction=1)).detach()
    gs = _safe_std(gt.reshape(-1).var(correction=1)).detach()
    return margin_l2_loss(
        normalize_patches(patchify(pred, patch_size), std=ps),
        normalize_patches(patchify(gt, patch_size), std=gs), margin)


def loss_depth_smoothness(depth: torch.Tensor,
                          img: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness. depth: (H, W) or (H, W, 1); img: (H, W, C)."""
    if depth.ndim == 2:
        depth = depth[..., None]
    img_gx = img[:, :-1, :] - img[:, 1:, :]
    img_gy = img[:-1, :, :] - img[1:, :, :]
    wx = torch.exp(-torch.abs(img_gx).mean(-1, keepdim=True))
    wy = torch.exp(-torch.abs(img_gy).mean(-1, keepdim=True))
    dx = torch.abs(depth[:, :-1, :] - depth[:, 1:, :])
    dy = torch.abs(depth[:-1, :, :] - depth[1:, :, :])
    return ((dx * wx).sum() + (dy * wy).sum()) / (wx.sum() + wy.sum())
