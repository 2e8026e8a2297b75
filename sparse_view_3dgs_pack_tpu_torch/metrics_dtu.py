#!/usr/bin/env python3
"""Masked DTU evaluation of the port:

    python -m sparse_view_3dgs_pack_tpu_torch.metrics_dtu -m <model_dir> \
        -s <dtu_scene> [--device cuda]

The port's copy of the root `metrics_dtu.py` (reference
`DNGaussian/metrics_dtu.py:28-41`): PSNR, SSIM and LPIPS inside the object
masks `<scene>/idr_masks/<name>` (resized to the render when their size
differs), the background black in render and ground truth alike, written
to `<model>/results_dtu.json`. A missing mask scores the whole image.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .metrics.image_metrics import psnr_metric, ssim_metric
from .metrics.lpips import lpips, lpips_is_proxy
from .utils import image_io


def _mask(path: Path, shape) -> np.ndarray:
    """(H, W, 1) float32 0/1 mask, > 127.5 inside the object."""
    if not path.exists():
        return np.ones(shape[:2] + (1,), np.float32)
    m = image_io.read_image(str(path))
    if m.shape[:2] != shape[:2]:
        from PIL import Image
        m = np.asarray(Image.fromarray(m).resize((shape[1], shape[0])))
    m = np.asarray(m, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return (m > 127.5)[..., None].astype(np.float32)


def evaluate_dtu(model_paths, source_path: str, device) -> None:
    lpips_key = "LPIPS_proxy" if lpips_is_proxy() else "LPIPS"
    for scene_dir in model_paths:
        results = {}
        test_dir = Path(scene_dir) / "test"
        if not test_dir.exists():
            print(f"{scene_dir}: no test renders")
            continue
        for method in sorted(os.listdir(test_dir)):
            renders_dir = test_dir / method / "renders"
            gt_dir = test_dir / method / "gt"
            psnrs, ssims, lpipss = [], [], []
            for fname in sorted(os.listdir(renders_dir)):
                render = np.asarray(image_io.read_image(
                    str(renders_dir / fname)), np.float32)[..., :3] / 255
                gt = np.asarray(image_io.read_image(str(gt_dir / fname)),
                                np.float32)[..., :3] / 255
                mask = _mask(Path(source_path) / "idr_masks" / fname,
                             render.shape)
                r = torch.as_tensor(render * mask, device=device)
                g = torch.as_tensor(gt * mask, device=device)
                psnrs.append(float(psnr_metric(r, g)))
                ssims.append(float(ssim_metric(r, g)))
                lpipss.append(float(lpips(r, g)))
            results[method] = {"PSNR": sum(psnrs) / len(psnrs),
                               "SSIM": sum(ssims) / len(ssims),
                               lpips_key: sum(lpipss) / len(lpipss)}
            print(f"{scene_dir} {method}: PSNR {results[method]['PSNR']:.3f}"
                  f" SSIM {results[method]['SSIM']:.4f} {lpips_key} "
                  f"{results[method][lpips_key]:.4f}")
        with open(os.path.join(scene_dir, "results_dtu.json"), "w") as f:
            json.dump(results, f, indent=2)


def main(argv=None) -> int:
    parser = ArgumentParser(description="Masked DTU evaluation")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    evaluate_dtu(args.model_paths, args.source_path,
                 resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
