"""GaussianModel: the trained point set as an nn.Module, PLY IO, and the
weight bridge from the JAX package.

Counterpart of `sparse_view_3dgs_pack_tpu/models/gaussians.py:42-63,
199-285`. The JAX `GaussianState` keeps fixed-capacity buffers with an alive
prefix (static shapes for XLA); eager PyTorch needs no padding, so the model
holds only the alive rows. Storage conventions are the reference's
(pre-activation):
  xyz           (N, 3)
  features_dc   (N, 1, C)      SH degree-0 coefficients
  features_rest (N, K-1, C)    higher SH coefficients
  scaling       (N, 3)         log-scale
  rotation      (N, 4)         unnormalised quaternion (w, x, y, z)
  opacity       (N, 1)         inverse-sigmoid
plus the `exposure` buffer (n_images, 3, 4).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from sparse_view_3dgs_pack_tpu.data import ply as ply_io

PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")


class GaussianModel(nn.Module):
    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, exposure=None, n_images: int = 1):
        super().__init__()
        values = dict(xyz=xyz, features_dc=features_dc,
                      features_rest=features_rest, scaling=scaling,
                      rotation=rotation, opacity=opacity)
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(
                torch.tensor(np.asarray(values[name], np.float32))))
        if exposure is None:
            exposure = np.broadcast_to(np.eye(3, 4, dtype=np.float32),
                                       (max(n_images, 1), 3, 4))
        self.register_buffer("exposure", torch.tensor(
            np.asarray(exposure, np.float32)))

    @property
    def max_sh_degree(self) -> int:
        k = self.features_dc.shape[1] + self.features_rest.shape[1]
        return int(round(k ** 0.5)) - 1

    def params(self) -> dict[str, torch.Tensor]:
        """name → parameter, the layout `renderer.render_core` takes."""
        return {name: getattr(self, name) for name in PARAM_NAMES}


def from_jax_params(params: dict, n_alive: int, exposure=None,
                    device: str | torch.device = "cpu") -> GaussianModel:
    """Rows [:n_alive] of each JAX `GaussianState.params` array (numpy, or
    anything `np.asarray` takes) → GaussianModel on `device`."""
    rows = {name: np.asarray(params[name])[:n_alive] for name in PARAM_NAMES}
    exp = None if exposure is None else np.asarray(exposure)
    return GaussianModel(**rows, exposure=exp).to(device)


def save_ply(model: GaussianModel, path: str) -> None:
    """Reference-schema PLY (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,
    scale_*,rot_*), binary little-endian; byte-identical to the JAX
    `save_ply` of the same rows."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    p = {k: v.detach().cpu().numpy() for k, v in model.params().items()}
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
    ply_io.write_ply(path, {k: np.asarray(v, np.float32)
                            for k, v in props.items()})


def load_ply(path: str, sh_degree: int = 3, n_images: int = 1,
             device: str | torch.device = "cpu",
             exposure: Optional[np.ndarray] = None) -> GaussianModel:
    """Read a reference-schema PLY written by either package."""
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
    return GaussianModel(xyz, f_dc, f_rest, scaling, rotation, opacity,
                         exposure=exposure, n_images=n_images).to(device)
