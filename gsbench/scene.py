"""A cell's inputs, made from the seed: a scene-like Gaussian cloud, cameras
on a ring around it and smooth targets of the frame size.

Everything the program is handed comes from here and is drawn on the
device by a `torch.Generator` of that device, in a few large calls, so the
same seed gives the same inputs (on the same kind of device). The
reference (`gsbench/reference/`) is handed the same.

The cloud is rotationally symmetric about the vertical axis (a ground disc,
a central object, a background shell), and the cameras share one ring, so
every view costs nearly the same: the traffic draws views from a shuffled
stack, and views of unequal cost would put the seed into the spread.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator of `device` seeded from (`seed`, `stream`): each kind of
    input draws from its own stream, so adding one leaves the others."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _part_points(part: dict, n: int, g, device) -> torch.Tensor:
    """(n, 3) centres of one part of the cloud (z up)."""
    u = torch.rand((n, 3), generator=g, device=device)
    if part["shape"] == "disc":
        r = part["radius"] * torch.sqrt(u[:, 0])
        a = 2 * math.pi * u[:, 1]
        z = part["z"] + part["thickness"] * (u[:, 2] - 0.5)
        return torch.stack([r * torch.cos(a), r * torch.sin(a), z], 1)
    if part["shape"] == "ball":
        d = torch.randn((n, 3), generator=g, device=device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        r = part["radius"] * u[:, :1] ** (1.0 / 3.0)
        return d * r + torch.tensor(part["center"], device=device)
    if part["shape"] == "shell":
        lo, hi = part["radius"]
        r = lo + (hi - lo) * u[:, 0]
        a = 2 * math.pi * u[:, 1]
        # elevation uniform in sin between the part's bounds: a band of the
        # sphere, as much sky as the capture shows
        s_lo, s_hi = (math.sin(math.radians(e)) for e in part["elevation"])
        s = s_lo + (s_hi - s_lo) * u[:, 2]
        c = torch.sqrt(1 - s * s)
        return torch.stack([r * c * torch.cos(a), r * c * torch.sin(a),
                            r * s], 1)
    raise ValueError(f"unknown part shape {part['shape']!r}")


def make_cloud(scene: dict, n: int, sh_degree: int, seed: int,
               device) -> dict:
    """The Gaussians' parameters in the port's storage convention
    (pre-activation; `features_dc` (n, 1, 3), `features_rest` (n, K-1, 3)),
    float32 on `device`. Each part takes its share of the rows; its log
    scales are uniform in its `log_scale` range per axis; rotations are
    uniform; opacities are sigmoid(N(mean, std)); SH coefficients normal."""
    g = generator(seed, device, 1)
    parts = scene["parts"]
    counts = [int(round(p["share"] * n)) for p in parts]
    counts[-1] = n - sum(counts[:-1])
    xyz = torch.cat([_part_points(p, k, g, device)
                     for p, k in zip(parts, counts)])
    lo = torch.cat([torch.full((k, 1), float(p["log_scale"][0]),
                               device=device) for p, k in zip(parts, counts)])
    hi = torch.cat([torch.full((k, 1), float(p["log_scale"][1]),
                               device=device) for p, k in zip(parts, counts)])
    u = torch.rand((n, 3), generator=g, device=device)
    scaling = lo + (hi - lo) * u
    rotation = torch.randn((n, 4), generator=g, device=device)
    rotation = rotation / torch.linalg.vector_norm(rotation, dim=1,
                                                   keepdim=True)
    mean, std = scene["opacity_logit"]
    opacity = mean + std * torch.randn((n, 1), generator=g, device=device)
    k = (sh_degree + 1) ** 2
    dc = scene["dc_std"] * torch.randn((n, 1, 3), generator=g, device=device)
    rest = scene["rest_std"] * torch.randn((n, k - 1, 3), generator=g,
                                           device=device)
    return dict(xyz=xyz.contiguous(), features_dc=dc, features_rest=rest,
                scaling=scaling, rotation=rotation, opacity=opacity)


def adam_moments(params: dict, scale: float, seed: int) -> tuple:
    """(m, v) of a warm Adam: first moments 0, second moments scale² ×
    U(0.5, 1.5) elementwise, drawn on each parameter's device. With √v well
    above a step's gradient, a step moves each parameter in proportion to
    its gradient, so the parameters' change follows the gradient."""
    g = generator(seed, next(iter(params.values())).device, 2)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: scale * scale * (0.5 + torch.rand(p.shape, generator=g,
                                              device=p.device))
         for k, p in params.items()}
    return m, v


class View(NamedTuple):
    """One camera, float32 numpy, in the port's `CameraParams` layout (math
    convention: p_cam = viewmat @ p_world, clip = full_proj @ p_world;
    the camera looks down +z, y down)."""
    viewmat: np.ndarray
    full_proj: np.ndarray
    cam_center: np.ndarray
    tan_fovx: np.float32
    tan_fovy: np.float32


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World → camera 4x4 (float64) of a camera at `eye` looking at
    `target`."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    vm = np.eye(4)
    vm[:3, :3] = np.stack([right, down, fwd])
    vm[:3, 3] = -vm[:3, :3] @ eye
    return vm


def projection(znear: float, zfar: float, tan_x: float,
               tan_y: float) -> np.ndarray:
    """The 3DGS perspective projection (camera space → clip, NDC z in
    [0, 1])."""
    p = np.zeros((4, 4))
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def ring_views(ring: dict, n: int, width: int, height: int, focal: float,
               seed: int, stream: int) -> list:
    """`n` cameras spread evenly around the ring (a seeded phase), each
    with its radius and height moved by up to ± the ring's `jitter`, all
    looking at the ring's target."""
    rng = np.random.default_rng([int(seed) % (1 << 63), stream])
    phase = rng.uniform(0, 2 * math.pi)
    jit = rng.uniform(-1, 1, (n, 2)) * ring["jitter"]
    tan_x, tan_y = width / (2 * focal), height / (2 * focal)
    proj = projection(0.01, 100.0, tan_x, tan_y)
    views = []
    for i in range(n):
        a = phase + 2 * math.pi * i / n
        r, h = ring["radius"] + jit[i, 0], ring["height"] + jit[i, 1]
        eye = (r * math.cos(a), r * math.sin(a), h)
        vm = look_at(eye, ring["target"])
        views.append(View(vm.astype(np.float32),
                          (proj @ vm).astype(np.float32),
                          np.asarray(eye, np.float32), np.float32(tan_x),
                          np.float32(tan_y)))
    return views


def make_targets(spec: dict, n: int, width: int, height: int, seed: int,
                 device, out: torch.Tensor | None = None,
                 only: list | None = None):
    """Smooth targets in [0, 1]: per view, 0.5 plus a sum of
    `spec["waves"]` plane waves of at most `spec["max_cycles"]` cycles
    across the frame, per channel, clipped. All `n` views' waves are drawn
    at once; the images are made one view at a time, into `out` (n, H, W,
    3) when given (the program's own target buffer), or, for the views in
    `only`, returned as a list."""
    g = generator(seed, device, 3)
    k = spec["waves"]
    freq = (torch.rand((n, k, 2), generator=g, device=device) * 2 - 1) \
        * spec["max_cycles"] * 2 * math.pi
    phase = torch.rand((n, k, 3), generator=g, device=device) * 2 * math.pi
    amp = torch.rand((n, k, 1), generator=g, device=device) * (0.5 / k)
    y = (torch.arange(height, device=device, dtype=torch.float32)
         / height)[:, None, None]
    x = (torch.arange(width, device=device, dtype=torch.float32)
         / width)[None, :, None]

    def image(i):
        arg = x * freq[i, :, 0] + y * freq[i, :, 1]             # (H, W, k)
        wave = torch.sin(arg[..., None] + phase[i])             # (H, W, k, 3)
        return torch.clamp(0.5 + (amp[i] * wave).sum(2), 0, 1)

    if only is not None:
        return [image(i) for i in only]
    if out is None:
        out = torch.empty((n, height, width, 3), device=device)
    for i in range(n):
        out[i] = image(i)
    return out
