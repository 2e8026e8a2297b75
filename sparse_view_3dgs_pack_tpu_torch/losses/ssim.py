"""SSIM with an 11×11 σ=1.5 Gaussian window, zero-padded 'same' convs.

Counterpart of `ssim` in `sparse_view_3dgs_pack_tpu/losses/ssim.py` (the
conv-SSIM of the reference, `LGDWT-GS/utils/loss_utils.py:48-90`), on
(H, W, C) images as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tracing import span

# cuDNN runs float32 convolutions in TF32 by default (~3 decimal digits);
# the metric is reported to 1e-4, so its convolutions stay in full f32.
torch.backends.cudnn.allow_tf32 = False

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """img1, img2: (H, W, C) float32. Mean SSIM, or the (H, W, C) map."""
    C = img1.shape[-1]
    with span("sync/ssim_window"):     # a copy from the host's window
        win = torch.as_tensor(_gaussian_window(window_size),
                              device=img1.device)
    win = win.expand(C, 1, window_size, window_size).contiguous()
    x = img1.permute(2, 0, 1)[None].to(torch.float32)
    y = img2.permute(2, 0, 1)[None].to(torch.float32)

    def conv(z):
        return F.conv2d(z, win, padding=window_size // 2, groups=C)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map[0].permute(1, 2, 0)
