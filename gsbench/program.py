"""The system under test, built from a cell's inputs: the port's
`GaussianModel` holding the seed-made cloud, its cameras, and the
`Trainer` restored to a configuration's iteration.

Everything here goes through the port's public objects; the benchmark
hands it the inputs of `gsbench/scene.py` and reads back only what the
program's own entry points return and hold.
"""

from __future__ import annotations

import gc
import random
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import scene


class Camera:
    """A view in the shape the port's renderer and `CameraBank` read: no
    image, mask or depth of its own (the targets are written into the
    trainer's bank on the device)."""
    image = alpha_mask = invdepthmap = depth_mask = nir = None
    depth_reliable = False

    def __init__(self, view: scene.View, width: int, height: int):
        self.view, self.width, self.height = view, width, height

    def params(self) -> scene.View:
        return self.view


class Scene:
    """What `Trainer` reads of a scene."""

    def __init__(self, model, cameras, extent: float):
        self.gaussians, self.cameras, self.cameras_extent = (model, cameras,
                                                             extent)
        self.model_path = ""

    def getTrainCameras(self):
        return self.cameras


KERNELS = ("raster_fwd", "raster_bwd")   # the sources the cells' paths run


def build_kernels() -> None:
    """Compile the port's kernel sources at once, where the checkout has no
    library for them yet (`build/kernels/` in the checkout)."""
    from sparse_view_3dgs_pack_tpu_torch.ops import _build
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for f in [pool.submit(_build.build, n) for n in KERNELS]:
            f.result()


def model(params: dict, n_images: int):
    """The port's `GaussianModel` holding `params` (its rows become the
    model's parameters, on their device)."""
    from sparse_view_3dgs_pack_tpu_torch.models.gaussians import GaussianModel
    k = params["features_rest"].shape[1]
    one = GaussianModel(np.zeros((1, 3)), np.zeros((1, 1, 3)),
                        np.zeros((1, k, 3)), np.zeros((1, 3)),
                        np.zeros((1, 4)), np.zeros((1, 1)),
                        n_images=n_images)
    one = one.to(params["xyz"].device)
    one.set_rows(params)
    return one


def extent(views) -> float:
    """The 3DGS scene extent: 1.1 × the largest distance of a camera from
    the cameras' mean (`getNerfppNorm`), the scale of the position LR."""
    c = np.stack([v.cam_center for v in views]).astype(np.float64)
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


def trainer(cfg: dict, params: dict, views: list, seed: int, device):
    """A `Trainer` of the configuration's method holding `params`, its
    targets drawn into its camera bank, restored to iteration
    `cfg["iteration"]` (SH degree as a checkpoint there gives it) with the
    seed's warm Adam moments; the host RNGs seeded."""
    from sparse_view_3dgs_pack_tpu_torch.config import METHOD_OPTS
    from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
    W, H = cfg["width"], cfg["height"]
    m = model(params, len(views))
    cams = [Camera(v, W, H) for v in views]
    opt = Namespace(**{**METHOD_OPTS[cfg["method"]], **cfg["opt"]})
    pipe = Namespace(debug=False, debug_from=-1, antialiasing=False)
    args = Namespace(sh_degree=cfg["sh_degree"], white_background=False,
                     train_test_exp=False, source_path="", model_path="")
    tr = Trainer(Scene(m, cams, extent(views)), opt, pipe, args)
    scene.make_targets(cfg["targets"], len(views), W, H, seed, device,
                       out=tr.bank.gt)
    it = cfg["iteration"]
    tr.iteration = tr.start_iteration = it
    tr.active_sh_degree = min(it // 1000, cfg["sh_degree"])
    tr.adam.m, tr.adam.v = scene.adam_moments(m.params(), cfg["adam_v_scale"],
                                              seed)
    tr.adam.step = tr.exp_adam.step = it
    random.seed(seed)
    np.random.seed(seed % (1 << 32))
    return tr


def taken_view(before: list, after: list, n: int) -> int:
    """The view a `Trainer.step` took, from its stack before and after."""
    left = set(before) if before else set(range(n))
    (idx,) = left - set(after)
    return idx


def free() -> None:
    """Release what the dropped references held, on the card too."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
