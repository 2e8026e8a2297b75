"""Mono-depth prior providers.

Counterpart of `sparse_view_3dgs_pack_tpu/depth/estimator.py`. The
reference loads MiDaS DPT_Hybrid from torch.hub at import time
(`FSGS/utils/depth_utils.py:3-11`); an offline deployment has no hub
downloads, so depth priors are pluggable:

* ``precomputed`` — `<source>/depth_maps/<image-stem>.{npy,png}` (MiDaS or
  DPT run offline on a machine that has the weights); a map of another
  size is resized bilinearly with half-pixel centres, cv2's INTER_LINEAR
  (`F.interpolate(..., "bilinear", align_corners=False)`); PNGs are read
  through `utils/image_io.py` (no cv2);
* ``midas`` — torch.hub MiDaS DPT_Hybrid, loaded only from a hub cache that
  already holds both the repository and the weights: nothing is fetched;
* ``none`` — no depth priors (the losses are gated by has_depth = 0);
* ``auto`` — precomputed if the directory exists, else midas if cached,
  else none (with a warning).
"""

from __future__ import annotations

import glob
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import image_io

MIDAS_REPO = "intel-isl_MiDaS_master"   # torch.hub's directory of the repo


class DepthEstimator:
    available = False
    can_estimate = False   # can score arbitrary (novel) rendered images

    def depth_for_camera(self, cam):
        """(H, W) float mono depth for a training camera, or None."""
        return None

    def estimate(self, image_hwc):
        """(H, W) mono depth for an arbitrary rendered image, or None."""
        return None


class NoDepth(DepthEstimator):
    pass


def resize_bilinear(d: np.ndarray, width: int, height: int) -> np.ndarray:
    """(h, w) → (height, width) float32, bilinear with half-pixel centres
    and edge clamping (cv2.resize INTER_LINEAR)."""
    t = torch.as_tensor(np.asarray(d, np.float32))[None, None]
    return F.interpolate(t, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0].numpy()


class PrecomputedDepth(DepthEstimator):
    available = True      # per-camera priors only
    can_estimate = False  # cannot score novel renders from disk

    def __init__(self, depth_dir: str):
        self.depth_dir = depth_dir

    def depth_for_camera(self, cam):
        stem = os.path.splitext(cam.image_name)[0]
        for ext in (".npy", ".png"):
            path = os.path.join(self.depth_dir, stem + ext)
            if os.path.exists(path):
                d = (np.load(path) if ext == ".npy"
                     else image_io.read_image(path))
                d = np.asarray(d, np.float32)
                if d.shape != (cam.height, cam.width):
                    d = resize_bilinear(d, cam.width, cam.height)
                return d
        return None


def midas_cache(hub_dir: str):
    """(repository directory, weights file) of a torch.hub cache that holds
    MiDaS DPT_Hybrid, or None."""
    repo = os.path.join(hub_dir, MIDAS_REPO)
    weights = sorted(glob.glob(os.path.join(hub_dir, "checkpoints",
                                            "dpt_hybrid*")))
    if os.path.isfile(os.path.join(repo, "hubconf.py")) and weights:
        return repo, weights[0]
    return None


def _no_download(url, *args, **kwargs):
    raise RuntimeError(f"MiDaS asked to download {url}; the port loads it "
                       f"only from the torch.hub cache")


class MidasDepth(DepthEstimator):
    """torch.hub MiDaS DPT_Hybrid from the local cache. The repository is
    loaded with `source="local"` (a GitHub source would ask the network
    for its default branch) and only once its weights are in the cache's
    `checkpoints/`, where the hub looks before it would download; while it
    loads, the hub's download function raises."""

    available = True
    can_estimate = True

    def __init__(self, hub_dir: str | None = None):
        hub_dir = hub_dir or torch.hub.get_dir()
        found = midas_cache(hub_dir)
        if found is None:
            raise RuntimeError(f"no MiDaS DPT_Hybrid repository and weights "
                               f"in the torch.hub cache {hub_dir}; nothing "
                               f"is downloaded")
        prev = torch.hub.get_dir(), torch.hub.download_url_to_file
        torch.hub.set_dir(hub_dir)
        torch.hub.download_url_to_file = _no_download
        try:
            self.midas = torch.hub.load(found[0], "DPT_Hybrid",
                                        source="local")
        finally:
            torch.hub.set_dir(prev[0])
            torch.hub.download_url_to_file = prev[1]
        self.midas.eval()
        for p in self.midas.parameters():
            p.requires_grad = False

    @torch.no_grad()
    def estimate(self, image_hwc):
        """(H, W, 3) in [0, 1], array or tensor → (H, W) relative
        disparity, on the image's device."""
        img = torch.as_tensor(image_hwc, dtype=torch.float32)
        self.midas.to(img.device)
        h, w = img.shape[:2]
        norm = (img.permute(2, 0, 1)[None] - 0.5) / 0.5
        norm = F.interpolate(norm, size=(384, 512), mode="bicubic",
                             align_corners=False)
        pred = self.midas(norm)
        pred = F.interpolate(pred.unsqueeze(1), size=(h, w), mode="bicubic",
                             align_corners=False)
        return pred[0, 0]

    def depth_for_camera(self, cam):
        if cam.image is None:
            return None
        return self.estimate(cam.image).cpu().numpy()


def get_depth_estimator(kind: str, source_path: str) -> DepthEstimator:
    depth_dir = os.path.join(source_path, "depth_maps")
    if kind == "precomputed" or (kind == "auto" and os.path.isdir(depth_dir)):
        return PrecomputedDepth(depth_dir)
    if kind in ("midas", "auto"):
        try:
            return MidasDepth()
        except Exception as e:
            if kind == "midas":
                raise
            warnings.warn(f"depth priors disabled ({e}); precompute "
                          f"<source>/depth_maps/ to enable them")
    elif kind != "none":
        raise ValueError(f"unknown depth estimator {kind!r}")
    return NoDepth()


def attach_priors(cams, estimator: DepthEstimator, to_prior=None) -> None:
    """Each camera's mono depth from `estimator` (through `to_prior`,
    where given) as its `invdepthmap`, with an all-ones `depth_mask` and
    `depth_reliable` set: the inverse-depth slot a trainer's camera bank
    reads. A camera the estimator has no depth for is left as it is."""
    for c in cams:
        d = estimator.depth_for_camera(c)
        if d is not None:
            d = np.asarray(d)
            c.invdepthmap = (d if to_prior is None
                             else to_prior(d)).astype(np.float32)
            c.depth_mask = np.ones_like(c.invdepthmap)
            c.depth_reliable = True
