from .image_metrics import psnr_metric, ssim_metric

__all__ = ["psnr_metric", "ssim_metric"]
