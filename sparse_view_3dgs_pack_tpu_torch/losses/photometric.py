"""Photometric losses (counterpart of
`sparse_view_3dgs_pack_tpu/losses/photometric.py`; reference
`utils/loss_utils.py:40-46`). Images are (H, W, C) float32 in [0, 1]."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()
