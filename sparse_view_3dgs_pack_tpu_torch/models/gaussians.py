"""GaussianModel: the point set as an nn.Module, its initialisation from a
point cloud, PLY IO, and the weight bridge from the JAX package.

Counterpart of `sparse_view_3dgs_pack_tpu/models/gaussians.py`. The JAX
`GaussianState` keeps fixed-capacity buffers with an alive prefix (static
shapes for XLA); eager PyTorch needs no padding, so the model holds only
the alive rows, and densification replaces its parameters with new ones of
another length. Storage conventions are the reference's (pre-activation):
  xyz           (N, 3)
  features_dc   (N, 1, C)      SH degree-0 coefficients
  features_rest (N, K-1, C)    higher SH coefficients
  scaling       (N, 3)         log-scale
  rotation      (N, 4)         unnormalised quaternion (w, x, y, z)
  opacity       (N, 1)         inverse-sigmoid
plus, for mult-dwtgs (JAX `gaussians.py:139-142`), the optional
  nir_albedo    (N, 1)         inverse-sigmoid, one row per Gaussian
  nir_gain      (1,)           one gain for the whole model
and the buffers `exposure` (n_images, 3, 4) and the densification
statistics `xyz_gradient_accum`, `denom`, `max_radii2d` (N,). The row
parameters (`row_names()`) follow the Gaussians through densification;
`nir_gain` is never indexed by row.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..data import ply as ply_io
from ..device import resolve_device
from ..ops.knn import dist2_for_scale_init
from ..utils.general import inverse_sigmoid
from ..utils.sh import rgb2sh

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")
NIR_ALBEDO, NIR_GAIN = "nir_albedo", "nir_gain"
STAT_NAMES = ("xyz_gradient_accum", "denom", "max_radii2d")


class GaussianModel(nn.Module):
    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, exposure=None, n_images: int = 1,
                 nir_albedo=None, nir_gain=None):
        """`nir_albedo` (N, 1) gives the model the NIR parameters, its gain
        `nir_gain` (1,) defaulting to 1."""
        super().__init__()
        values = dict(xyz=xyz, features_dc=features_dc,
                      features_rest=features_rest, scaling=scaling,
                      rotation=rotation, opacity=opacity)
        if nir_albedo is not None:
            values[NIR_ALBEDO] = nir_albedo
            values[NIR_GAIN] = np.ones(1) if nir_gain is None else nir_gain
        else:
            self.register_parameter(NIR_ALBEDO, None)
            self.register_parameter(NIR_GAIN, None)
        # contiguous: the Adam kernel takes no strided parameter, and a
        # PLY's SH rows arrive transposed
        for name, value in values.items():
            setattr(self, name, nn.Parameter(
                torch.tensor(np.ascontiguousarray(value, np.float32))))
        if exposure is None:
            exposure = np.broadcast_to(np.eye(3, 4, dtype=np.float32),
                                       (max(n_images, 1), 3, 4))
        self.register_buffer("exposure", torch.tensor(
            np.asarray(exposure, np.float32)))
        n = self.xyz.shape[0]
        for name in STAT_NAMES:
            self.register_buffer(name, torch.zeros(n))

    @property
    def max_sh_degree(self) -> int:
        k = self.features_dc.shape[1] + self.features_rest.shape[1]
        return int(round(k ** 0.5)) - 1

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    @property
    def has_nir(self) -> bool:
        return self.nir_albedo is not None

    def row_names(self) -> tuple:
        """The parameters with one row per Gaussian."""
        return PARAM_NAMES + ((NIR_ALBEDO,) if self.has_nir else ())

    def params(self) -> dict[str, torch.Tensor]:
        """name → parameter, the layout `renderer.render_core` takes (the
        NIR parameters too, where the model has them)."""
        names = self.row_names() + ((NIR_GAIN,) if self.has_nir else ())
        return {name: getattr(self, name) for name in names}

    @torch.no_grad()
    def set_rows(self, params: dict[str, torch.Tensor]) -> None:
        """Replace every row parameter with a new tensor (densification
        changes the row count; `params` holds each of `row_names()`) and
        zero the densification statistics. `nir_gain` stays as it is."""
        for name in self.row_names():
            setattr(self, name, nn.Parameter(params[name].contiguous()))
        for name in STAT_NAMES:
            setattr(self, name, torch.zeros(self.xyz.shape[0],
                                            device=self.xyz.device))

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        """(N,) activated opacity."""
        return torch.sigmoid(self.opacity[:, 0])


def create_from_pcd(points: np.ndarray, colors: np.ndarray, n_images: int,
                    sh_degree: int = 3, channels: int = 3,
                    use_nir: bool = False, init_opacity: float = 0.1,
                    device: str | torch.device = "cuda") -> GaussianModel:
    """Initialise from a point cloud (JAX `create_from_pcd`, reference
    `gaussian_model.py:149-176`): SH-DC from colours, log-scale from the
    mean squared distance to the 3 nearest neighbours (exact, on `device`),
    identity rotations, opacity 0.1; with `use_nir` an NIR albedo of 0.5
    and a gain of 1."""
    device = resolve_device(device)
    n = points.shape[0]
    K = (sh_degree + 1) ** 2
    xyz = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32)[:, :channels],
                           device=device)
    f_dc = rgb2sh(cols)[:, None, :]
    f_rest = torch.zeros((n, K - 1, channels), device=device)
    d2 = dist2_for_scale_init(xyz)
    scaling = torch.log(torch.sqrt(d2))[:, None].repeat(1, 3)
    rotation = torch.zeros((n, 4), device=device)
    rotation[:, 0] = 1.0
    opacity = torch.full((n, 1), float(inverse_sigmoid(
        torch.tensor(init_opacity, dtype=torch.float32))), device=device)
    nir_albedo = (np.full((n, 1), float(inverse_sigmoid(
        torch.tensor(0.5, dtype=torch.float32))), np.float32)
        if use_nir else None)
    model = GaussianModel(xyz.cpu().numpy(), f_dc.cpu().numpy(),
                          f_rest.cpu().numpy(), scaling.cpu().numpy(),
                          rotation.cpu().numpy(), opacity.cpu().numpy(),
                          n_images=n_images, nir_albedo=nir_albedo)
    return model.to(device)


def save_exposure_json(model: GaussianModel, image_names, path: str) -> None:
    """`exposure.json` sidecar (reference `scene/__init__.py:86-95`)."""
    exp = model.exposure.detach().cpu().numpy()
    out = {name: exp[min(i, len(exp) - 1)].tolist()
           for i, name in enumerate(image_names)}
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def from_jax_params(params: dict, n_alive: int, exposure=None,
                    device: str | torch.device = "cuda",
                    stats: Optional[dict] = None) -> GaussianModel:
    """Rows [:n_alive] of each JAX `GaussianState.params` array (numpy, or
    anything `np.asarray` takes; `nir_gain` whole) → GaussianModel on
    `device`. `stats`: name → the JAX state's `xyz_gradient_accum` /
    `denom` / `max_radii2d` (capacity-long; alive rows are taken)."""
    device = resolve_device(device)
    rows = {name: np.asarray(params[name])[:n_alive] for name in PARAM_NAMES}
    if NIR_ALBEDO in params:
        rows[NIR_ALBEDO] = np.asarray(params[NIR_ALBEDO])[:n_alive]
        rows[NIR_GAIN] = np.asarray(params[NIR_GAIN])
    exp = None if exposure is None else np.asarray(exposure)
    model = GaussianModel(**rows, exposure=exp)
    for name, value in (stats or {}).items():
        setattr(model, name, torch.tensor(
            np.asarray(value, np.float32)[:n_alive]))
    return model.to(device)


class BridgedState(NamedTuple):
    model: GaussianModel
    adam: object        # train.optim.AdamState or None
    exp_adam: object    # train.optim.ExposureAdamState or None


def from_jax_state(state, adam=None, exp_adam=None,
                   device: str | torch.device = "cuda") -> BridgedState:
    """A JAX `GaussianState` (its params, exposure and statistics) and
    optionally its `AdamState` / `ExposureAdam` → the port's model and
    optimizer states, alive rows only. Duck-typed: anything with the same
    attributes and numpy-convertible arrays works."""
    from ..train.optim import AdamState, ExposureAdamState
    device = resolve_device(device)
    n = int(state.n_alive)
    model = from_jax_params(
        state.params, n, exposure=state.exposure, device=device,
        stats={name: getattr(state, name) for name in STAT_NAMES})

    def rows(d):
        out = {k: torch.tensor(np.asarray(d[k])[:n], device=device)
               for k in model.row_names()}
        if model.has_nir:
            out[NIR_GAIN] = torch.tensor(np.asarray(d[NIR_GAIN]),
                                         device=device)
        return out

    port_adam = None if adam is None else AdamState(
        m=rows(adam.m), v=rows(adam.v), step=int(adam.step))
    port_exp = None if exp_adam is None else ExposureAdamState(
        m=torch.tensor(np.asarray(exp_adam.m), device=device),
        v=torch.tensor(np.asarray(exp_adam.v), device=device),
        step=int(exp_adam.step))
    return BridgedState(model, port_adam, port_exp)


def save_ply(model: GaussianModel, path: str) -> None:
    """Reference-schema PLY (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,
    scale_*,rot_*, and nir_albedo where the model has it), binary
    little-endian; byte-identical to the JAX `save_ply` of the same rows.
    As there, the PLY holds no `nir_gain` (JAX `gaussians.py:203-205`)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    p = {k: getattr(model, k).detach().cpu().numpy()
         for k in model.row_names()}
    n = p["xyz"].shape[0]

    props = {}
    xyz = p["xyz"]
    props["x"], props["y"], props["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    zeros = np.zeros(n, np.float32)
    props["nx"], props["ny"], props["nz"] = zeros, zeros.copy(), zeros.copy()
    f_dc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = np.ascontiguousarray(f_dc[:, i])
    f_rest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = np.ascontiguousarray(f_rest[:, i])
    props["opacity"] = p["opacity"][:, 0]
    for i in range(3):
        props[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(4):
        props[f"rot_{i}"] = p["rotation"][:, i]
    if NIR_ALBEDO in p:
        props[NIR_ALBEDO] = p[NIR_ALBEDO][:, 0]
    ply_io.write_ply(path, {k: np.asarray(v, np.float32)
                            for k, v in props.items()})


def load_ply(path: str, sh_degree: int = 3, n_images: int = 1,
             device: str | torch.device = "cuda",
             exposure: Optional[np.ndarray] = None) -> GaussianModel:
    """Read a reference-schema PLY written by either package. An
    `nir_albedo` property gives the model its NIR parameters, the gain
    reset to 1 (the PLY holds none; JAX `gaussians.py:265-267`)."""
    device = resolve_device(device)
    v = ply_io.read_ply(path)
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    opacity = v["opacity"][:, None]
    n_dc = len([k for k in v if k.startswith("f_dc_")])
    channels = n_dc
    rest_names = sorted([k for k in v if k.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    K = (sh_degree + 1) ** 2
    if rest_names:
        f_rest = np.stack([v[k] for k in rest_names], axis=1)
        f_rest = f_rest.reshape(n, channels, K - 1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, K - 1, channels), np.float32)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(n_dc)],
                    axis=1).reshape(n, channels, 1).transpose(0, 2, 1)
    scaling = np.stack([v[f"scale_{i}"] for i in range(3)], axis=1)
    rotation = np.stack([v[f"rot_{i}"] for i in range(4)], axis=1)
    nir_albedo = v[NIR_ALBEDO][:, None] if NIR_ALBEDO in v else None
    return GaussianModel(xyz, f_dc, f_rest, scaling, rotation, opacity,
                         exposure=exposure, n_images=n_images,
                         nir_albedo=nir_albedo).to(device)
