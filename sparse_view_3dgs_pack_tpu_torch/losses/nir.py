"""Multispectral (RGB+NIR) losses of mult-dwtgs.

Counterpart of `sparse_view_3dgs_pack_tpu/losses/nir.py:17-43` (reference
`LGDWT-GS/mult-dwtgs/utils/loss_utils.py:93-171`). NIR images are (H, W)
single-channel; SSIM repeats the channel three times as the reference
does (the same value as a one-channel SSIM with a shared window).
"""

from __future__ import annotations

from typing import Optional

import torch

from .photometric import l1_loss
from .ssim import ssim


l1_loss_nir = l1_loss   # the JAX module's name for it


def ssim_loss_nir(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    return 1.0 - ssim(pred.repeat(1, 1, 3), gt.repeat(1, 1, 3))


def combined_nir_loss(pred: torch.Tensor, gt: torch.Tensor,
                      l1_weight: float = 1.0,
                      ssim_weight: float = 0.2) -> torch.Tensor:
    return (l1_weight * l1_loss(pred, gt)
            + ssim_weight * ssim_loss_nir(pred, gt))


def compute_combined_residuals(rgb_pred: torch.Tensor, rgb_gt: torch.Tensor,
                               nir_pred: Optional[torch.Tensor] = None,
                               nir_gt: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """(H, W) max of the RGB and NIR mean-abs residuals (densification
    guidance)."""
    rgb_res = (rgb_pred - rgb_gt).abs().mean(dim=-1)
    if nir_pred is not None and nir_gt is not None:
        nir_res = (nir_pred - nir_gt).abs()
        if nir_res.ndim == 3:
            nir_res = nir_res[..., 0]
        return torch.maximum(rgb_res, nir_res)
    return rgb_res
