"""Photometric losses (counterpart of
`sparse_view_3dgs_pack_tpu/losses/photometric.py`; reference
`utils/loss_utils.py:40-46`). Images are (H, W, C) float32 in [0, 1]."""

from __future__ import annotations

from typing import Optional

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def l1_loss_mask(pred: torch.Tensor, gt: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 over the masked pixels (FSGS), the plain L1 without a mask."""
    if mask is None:
        return l1_loss(pred, gt)
    return ((pred - gt).abs() * mask).sum() / torch.clamp(mask.sum(),
                                                          min=1e-8)
