"""Evaluation metrics (counterpart of
`sparse_view_3dgs_pack_tpu/metrics/image_metrics.py`); LPIPS is in
`metrics/lpips.py`."""

from __future__ import annotations

from ..losses.ssim import ssim as _ssim
from ..utils.image import psnr as _psnr


def psnr_metric(img1, img2):
    """img: (H, W, C) in [0, 1]."""
    return _psnr(img1, img2)


def ssim_metric(img1, img2):
    return _ssim(img1, img2)
