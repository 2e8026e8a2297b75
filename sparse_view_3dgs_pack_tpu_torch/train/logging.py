"""TensorBoard reporting (counterpart of
`sparse_view_3dgs_pack_tpu/train/logging.py`; reference `training_report`,
`LGDWT-GS/train.py:316-354`). Uses tensorboardX when it is installed and
does nothing otherwise."""

from __future__ import annotations

import numpy as np


class TrainReporter:
    def __init__(self, model_path: str, enabled: bool = True):
        self.writer = None
        if not enabled:
            return
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(model_path)
        except Exception as e:
            print(f"[TB] disabled ({e})")

    def scalars(self, iteration: int, metrics: dict,
                prefix="train_loss_patches"):
        if self.writer is None:
            return
        mapping = {
            "l1": f"{prefix}/l1_loss",
            "loss": f"{prefix}/total_loss",
            "ssim": f"{prefix}/ssim",
            "dwt": f"{prefix}/dwt_total",
            "dwt_scale": f"{prefix}/dwt_scale_factor",
            "patch_dwt": f"{prefix}/patch_dwt_loss",
            "depth_l1": f"{prefix}/depth_l1",
            "n_pairs": "perf/n_pairs",
        }
        for key, tag in mapping.items():
            if key in metrics:
                self.writer.add_scalar(tag, float(metrics[key]), iteration)

    def iter_time(self, iteration: int, seconds: float):
        if self.writer is not None:
            self.writer.add_scalar("iter_time", seconds * 1000.0, iteration)

    def histogram(self, iteration: int, tag: str, values):
        if self.writer is not None:
            self.writer.add_histogram(tag, np.asarray(values), iteration)

    def wef_heatmaps(self, iteration: int, pred, gt, tag_prefix="wef"):
        """Wavelet-error-field heatmap images (reference `train.py` TB hooks,
        `loss_utils.py:165-327`)."""
        if self.writer is None:
            return
        from ..losses.dwt import compute_wef_maps, make_heatmap_rgb
        for key, val in compute_wef_maps(pred, gt).items():
            rgb = make_heatmap_rgb(val).detach().cpu().numpy()
            self.writer.add_image(f"{tag_prefix}/{key}",
                                  rgb.transpose(2, 0, 1), iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()
