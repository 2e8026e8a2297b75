"""A forward-facing (LLFF-style) cell's inputs, made from the seed: the
cameras on a short arc in front of the cloud, the depth priors, the neural
field's values and the warm Adam moments of a DNGaussian model, and the
port's `DNGTrainer` holding them.

The cloud and the photo targets come from `scene.py` (`make_cloud`,
`make_targets`); what is new here draws from streams of its own
(`scene.generator`), so the seed gives the same inputs to the program and
to the reference (`reference/dng.py`).
"""

from __future__ import annotations

import math
from argparse import Namespace

import numpy as np
import torch

from . import program, scene
from .reference.dng import field_values

STREAM_PRIORS, STREAM_FIELD, STREAM_FIELD_ADAM = 4, 5, 6


def arc_views(arc: dict, n: int, width: int, height: int, focal: float,
              seed: int) -> list:
    """`n` cameras spread evenly over `arc["degrees"]` of a circle of
    `arc["radius"]` about the target, at `arc["height"]`, facing it: a
    handheld forward-facing capture. The arc's middle points in a
    direction drawn from the seed; radius and height move by up to ±
    `arc["jitter"]`."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    mid = rng.uniform(0, 2 * math.pi)
    jit = rng.uniform(-1, 1, (n, 2)) * arc["jitter"]
    span = math.radians(arc["degrees"])
    tan_x, tan_y = width / (2 * focal), height / (2 * focal)
    proj = scene.projection(0.01, 100.0, tan_x, tan_y)
    views = []
    for i in range(n):
        a = mid + span * (i / max(n - 1, 1) - 0.5)
        r, h = arc["radius"] + jit[i, 0], arc["height"] + jit[i, 1]
        eye = np.asarray(arc["target"], np.float64) + (
            r * math.cos(a), r * math.sin(a), h)
        vm = scene.look_at(eye, arc["target"])
        views.append(scene.View(vm.astype(np.float32),
                                (proj @ vm).astype(np.float32),
                                eye.astype(np.float32), np.float32(tan_x),
                                np.float32(tan_y)))
    return views


class ArcCamera(program.Camera):
    """`program.Camera` with the pose and fields of view that the port's
    spiral path reads (`R`, `T`: world → camera is [Rᵀ | T])."""

    def __init__(self, view: scene.View, width: int, height: int):
        super().__init__(view, width, height)
        vm = np.asarray(view.viewmat, np.float64)
        self.R, self.T = vm[:3, :3].T, vm[:3, 3]
        self.fovx = 2 * math.atan(float(view.tan_fovx))
        self.fovy = 2 * math.atan(float(view.tan_fovy))


def make_priors(spec: dict, n: int, width: int, height: int, seed: int,
                device, only: list | None = None) -> list:
    """Smooth depth priors in [0, 255] (a mono-depth network's disparity
    scale): per view 127.5 × (1 + a sum of `spec["waves"]` plane waves of
    at most `spec["max_cycles"]` cycles), clipped; all `n` views' waves
    drawn at once, the maps of the views in `only` (all by default)."""
    g = scene.generator(seed, device, STREAM_PRIORS)
    k = spec["waves"]
    freq = (torch.rand((n, k, 2), generator=g, device=device) * 2 - 1) \
        * spec["max_cycles"] * 2 * math.pi
    phase = torch.rand((n, k), generator=g, device=device) * 2 * math.pi
    amp = torch.rand((n, k), generator=g, device=device) / k
    y = (torch.arange(height, device=device, dtype=torch.float32)
         / height)[:, None, None]
    x = (torch.arange(width, device=device, dtype=torch.float32)
         / width)[None, :, None]

    def prior(i):
        wave = torch.sin(x * freq[i, :, 0] + y * freq[i, :, 1] + phase[i])
        return 127.5 * torch.clamp(1 + (amp[i] * wave).sum(-1), 0, 2)

    return [prior(i) for i in (range(n) if only is None else only)]


def make_field(cfg: dict, seed: int, device) -> dict:
    """The field's parameters by the port's names, drawn from the seed."""
    return field_values(cfg["field"],
                        scene.generator(seed, device, STREAM_FIELD))


def field_moments(field: dict, scale: float, seed: int) -> tuple:
    """(m, v) of the field's warm Adam, as `scene.adam_moments` draws the
    Gaussians': m 0, v scale² × U(0.5, 1.5), from a stream of its own,
    drawn in the order of the names (whatever order `field` has)."""
    dev = next(iter(field.values())).device
    g = scene.generator(seed, dev, STREAM_FIELD_ADAM)
    m = {k: torch.zeros_like(p) for k, p in field.items()}
    v = {k: scale * scale * (0.5 + torch.rand(field[k].shape, generator=g,
                                              device=dev))
         for k in sorted(field)}
    return m, {k: v[k] for k in field}


def adam_steps(cfg: dict) -> tuple:
    """(the Gaussians' Adam steps, the field's) after `cfg["iteration"]`
    iterations: a hard and a photometric step an iteration, and a soft
    step in each after `soft_depth_start`, which adds one to both."""
    it = cfg["iteration"]
    soft = max(0, it - cfg["opt"]["soft_depth_start"])
    return 2 * it + soft, it + soft


def trainer(cfg: dict, params: dict, views: list, seed: int, device):
    """A `DNGTrainer` holding `params` and the seed's field, targets and
    priors in its camera bank, restored to iteration `cfg["iteration"]`
    (SH degree as the schedule gives it there) with the seed's warm Adam
    moments for the Gaussians and the field; its draws seeded."""
    from sparse_view_3dgs_pack_tpu_torch.train.dng_loop import DNGTrainer
    W, H = cfg["width"], cfg["height"]
    m = program.model(params, len(views))
    cams = [ArcCamera(v, W, H) for v in views]
    opt = Namespace(**cfg["opt"])
    pipe = Namespace(debug=False, debug_from=-1, antialiasing=False)
    args = Namespace(sh_degree=cfg["sh_degree"], white_background=False,
                     model_path="")
    tr = DNGTrainer(program.Scene(m, cams, program.extent(views)), opt, pipe,
                    args, seed=seed, near_range=cfg["near_range"])
    with torch.no_grad():
        for k, p in make_field(cfg, seed, device).items():
            tr.field.params()[k].copy_(p)
    scene.make_targets(cfg["targets"], len(views), W, H, seed, device,
                       out=tr.bank.gt)
    for i, prior in enumerate(make_priors(cfg["priors"], len(views), W, H,
                                          seed, device)):
        tr.bank.invdepth[i] = 255.0 - prior
    tr.bank.has_depth.fill_(1.0)
    it = cfg["iteration"]
    tr.iteration = it
    tr.active_sh_degree = min(it // 1000, cfg["sh_degree"])
    tr.adam.m, tr.adam.v = scene.adam_moments(m.params(),
                                              cfg["adam_v_scale"], seed)
    tr.field_adam.m, tr.field_adam.v = field_moments(
        tr.field.params(), cfg["adam_v_scale"], seed)
    tr.adam.step, tr.field_adam.step = adam_steps(cfg)
    return tr
