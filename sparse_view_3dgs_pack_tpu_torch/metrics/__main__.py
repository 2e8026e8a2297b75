"""Evaluation CLI of the port:

    python -m sparse_view_3dgs_pack_tpu_torch.metrics -m <model_dir> [--device cuda]

Output-compatible with the root `metrics.py` (reference
`LGDWT-GS/metrics.py:36-103`): walks `<model>/test/ours_<iter>/{renders,gt}`
and writes `results.json` and `per_view.json` with SSIM, PSNR and the VGG
LPIPS (`metrics/lpips.py`): under `LPIPS`, or under `LPIPS_proxy` when no
converted weights are installed, with `LPIPS_backend` naming which in
`results.json` (root `metrics.py:69-85`).
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..utils import image_io
from .image_metrics import psnr_metric, ssim_metric
from .lpips import lpips, lpips_backend, lpips_is_proxy


def read_images(renders_dir: Path, gt_dir: Path):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        render = image_io.read_image(str(renders_dir / fname))
        gt = image_io.read_image(str(gt_dir / fname))
        renders.append(np.asarray(render, np.float32)[..., :3] / 255.0)
        gts.append(np.asarray(gt, np.float32)[..., :3] / 255.0)
        names.append(fname)
    return renders, gts, names


def evaluate(model_paths, device) -> bool:
    """Scores every method under each model's `test/`. Returns False when a
    model could not be scored (its traceback is printed, the others go on)."""
    ok = True
    # a proxy LPIPS (no converted weights) is never filed as the metric
    lpips_key = "LPIPS_proxy" if lpips_is_proxy() else "LPIPS"
    for scene_dir in model_paths:
        try:
            print("Scene:", scene_dir)
            full, per_view = {}, {}
            test_dir = Path(scene_dir) / "test"
            for method in sorted(os.listdir(test_dir)):
                print("Method:", method)
                method_dir = test_dir / method
                renders, gts, names = read_images(method_dir / "renders",
                                                  method_dir / "gt")
                ssims, psnrs, lpipss = [], [], []
                for r, g in zip(renders, gts):
                    r_t = torch.as_tensor(r, device=device)
                    g_t = torch.as_tensor(g, device=device)
                    ssims.append(float(ssim_metric(r_t, g_t)))
                    psnrs.append(float(psnr_metric(r_t, g_t)))
                    lpipss.append(float(lpips(r_t, g_t, net_type="vgg")))
                print("  SSIM : {:>12.7f}".format(sum(ssims) / len(ssims)))
                print("  PSNR : {:>12.7f}".format(sum(psnrs) / len(psnrs)))
                print("  {}: {:>12.7f}".format(lpips_key,
                                               sum(lpipss) / len(lpipss)))
                full[method] = {"SSIM": sum(ssims) / len(ssims),
                                "PSNR": sum(psnrs) / len(psnrs),
                                lpips_key: sum(lpipss) / len(lpipss),
                                "LPIPS_backend": lpips_backend()}
                per_view[method] = {"SSIM": dict(zip(names, ssims)),
                                    "PSNR": dict(zip(names, psnrs)),
                                    lpips_key: dict(zip(names, lpipss))}
            with open(os.path.join(scene_dir, "results.json"), "w") as f:
                json.dump(full, f, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
                json.dump(per_view, f, indent=True)
        except Exception:   # one bad model must not stop the others
            traceback.print_exc()
            print(f"Unable to compute metrics for model {scene_dir}")
            ok = False
    return ok


def main(argv=None) -> int:
    parser = ArgumentParser(description="Evaluation script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return 0 if evaluate(args.model_paths, resolve_device(args.device)) else 1


if __name__ == "__main__":
    sys.exit(main())
