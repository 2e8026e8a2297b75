"""Image metric helpers (counterpart of
`sparse_view_3dgs_pack_tpu/utils/image.py`)."""

from __future__ import annotations

import torch


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE; reduced over all but the leading batch axis when the
    inputs have more than three."""
    d = (img1 - img2) ** 2
    if d.ndim <= 3:
        return d.mean()
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    m = mse(img1, img2)
    return 20.0 * torch.log10(data_range / torch.sqrt(torch.clamp(m,
                                                                  min=1e-12)))
