"""Neural colour/opacity field: DNGaussian's GridRenderer as an nn.Module.

Counterpart of `sparse_view_3dgs_pack_tpu/models/neural_field.py`
(reference `DNGaussian/scene/neural_renderer.py:33-134`). sigma_net:
MLP(hash(32) → 64 → 64 → 1 + 64); color_net: MLP(SH(16) + geo(64) → 64 →
3); the colour activation is sigmoid·(1 + 2ε) − ε with ε = 1e-3. The
per-Gaussian opacity of the DNG model is sigmoid(sigma) · sigmoid(point
opacity) (reference `DNGaussian/scene/gaussian_model.py:141-157`).

The parameters are laid out as the JAX package lays them out (a layer's
`w` is (in, out)), and `save_neural_npz` / `load_neural_npz` use its npz
keys (`p['encoder']`, `p['sigma_net'][0]['w']`, …, `__cfg__`,
`__bound__`), so an npz written by either package loads in the other. The
MLP products run in float32 (TF32 off), outside any kernel, as in JAX.
`gaussian_outputs`, the field's one evaluation in training, runs under the
span "step/field" and its backward under "grad/field"
(`utils/tracing.py`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.hashgrid import HashGridConfig, hashgrid_encode, init_hashgrid
from ..ops.shencode import sh_encode
from ..utils.tracing import grad_span, span

torch.backends.cuda.matmul.allow_tf32 = False

COLOR_EPS = 1e-3


class NeuralFieldConfig(NamedTuple):
    grid: HashGridConfig = HashGridConfig()
    hidden_dim: int = 64
    geo_feat_dim: int = 64
    num_layers_sigma: int = 3
    hidden_dim_color: int = 64
    num_layers_color: int = 2
    sh_degree: int = 4
    bound: float = 1.0


class _Dense(nn.Module):
    """y = x @ w + b with w (in, out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def _init_mlp(generator: torch.Generator, dims) -> nn.ModuleList:
    """Kaiming-uniform fan-in limits (torch Linear's default), drawn from
    `generator`; the values differ from the JAX package's `jax.random`
    draws (`from_jax_params` carries those across)."""
    layers = []
    for i in range(len(dims) - 1):
        lim = (1.0 / dims[i]) ** 0.5
        u = lambda *s: (2.0 * torch.rand(s, generator=generator,
                                         device=generator.device) - 1) * lim
        layers.append(_Dense(u(dims[i], dims[i + 1]), u(dims[i + 1])))
    return nn.ModuleList(layers)


def _mlp(w: dict, name: str, n_layers: int, x: torch.Tensor) -> torch.Tensor:
    """The MLP `name` of `n_layers` layers, its weights read from `w`
    (parameter name → tensor)."""
    for i in range(n_layers):
        x = x @ w[f"{name}.{i}.w"] + w[f"{name}.{i}.b"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _dims(cfg: NeuralFieldConfig):
    sigma = ([cfg.grid.output_dim] + [cfg.hidden_dim]
             * (cfg.num_layers_sigma - 1) + [1 + cfg.geo_feat_dim])
    color = ([cfg.sh_degree ** 2 + cfg.geo_feat_dim]
             + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    return sigma, color


class NeuralField(nn.Module):
    """The hash-grid table `encoder`, `sigma_net`, `color_net` and the
    (untrained) `coord_center`, on the generator's device."""

    def __init__(self, cfg: NeuralFieldConfig = NeuralFieldConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        sigma_dims, color_dims = _dims(cfg)
        self.encoder = nn.Parameter(init_hashgrid(generator, cfg.grid))
        self.sigma_net = _init_mlp(generator, sigma_dims)
        self.color_net = _init_mlp(generator, color_dims)
        self.coord_center = nn.Parameter(torch.zeros(
            3, device=generator.device))

    def params(self) -> dict[str, torch.Tensor]:
        """name → parameter (`encoder`, `sigma_net.0.w`, …)."""
        return dict(self.named_parameters())

    # `w`, where given, stands for `params()`: the same tensors, or views
    # of them that carry a span of the backward (`gaussian_outputs`)
    def neural_density(self, x: torch.Tensor, w: dict | None = None):
        """x: (N, 3) → (sigma (N,), geo_feat (N, geo_feat_dim))."""
        w = self.params() if w is None else w
        enc = hashgrid_encode(w["encoder"], x - w["coord_center"],
                              self.cfg.grid, self.cfg.bound)
        h = _mlp(w, "sigma_net", len(self.sigma_net), enc)
        return h[:, 0], h[:, 1:]

    def neural_color(self, geo_feat: torch.Tensor, dirs: torch.Tensor,
                     w: dict | None = None):
        w = self.params() if w is None else w
        enc_d = sh_encode(dirs, self.cfg.sh_degree)
        h = _mlp(w, "color_net", len(self.color_net),
                 torch.cat([enc_d, geo_feat], -1))
        return torch.sigmoid(h) * (1 + 2 * COLOR_EPS) - COLOR_EPS

    def neural_forward(self, x: torch.Tensor, dirs: torch.Tensor,
                       w: dict | None = None):
        """(sigma (N,), colour (N, 3)), `GridRenderer.forward`."""
        w = self.params() if w is None else w
        sigma, geo = self.neural_density(x, w)
        return sigma, self.neural_color(geo, dirs, w)


def gaussian_outputs(field: NeuralField, xyz: torch.Tensor,
                     opacity: torch.Tensor, cam_center: torch.Tensor):
    """(colour (N, 3), opacity (N,)) of N Gaussians seen from `cam_center`:
    the field at each mean along the unit view direction, the opacity
    sigmoid(sigma) · sigmoid(the point's own opacity (N, 1)) (JAX
    `dng_loop._neural_outputs`, `renderer.py:260-267`). Runs under the
    span "step/field"; its backward, from the gradients of the colour and
    opacity to those of the field's parameters and the opacities, under
    "grad/field"."""
    with span("step/field"):
        # the means are not wrapped: their gradient sums the projection's
        # and both evaluations' in the photometric pass, in an order a
        # wrapper would change
        g = grad_span("grad/field")
        w = field.params()
        *ws, opacity = g.inputs(*w.values(), opacity)
        w = dict(zip(w, ws))
        dirs = xyz - cam_center[None, :]
        dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                           keepdim=True),
                                  min=1e-12)
        sigma, color = field.neural_forward(xyz, dirs, w)
        return g.outputs(color,
                         torch.sigmoid(sigma) * torch.sigmoid(opacity[:, 0]))


def npz_key(name: str) -> str:
    """The port's parameter name → the JAX npz key (`p` and the pytree
    key path): `sigma_net.0.w` → `p['sigma_net'][0]['w']`."""
    return "p" + "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                         for p in name.split("."))


def jax_leaf(params: dict, name: str):
    """The leaf of a JAX parameter pytree (nested dicts and lists) at the
    port's parameter `name`."""
    leaf = params
    for part in name.split("."):
        leaf = leaf[int(part)] if part.isdigit() else leaf[part]
    return leaf


def from_jax_params(params: dict, cfg: NeuralFieldConfig,
                    device: str | torch.device = "cuda") -> NeuralField:
    """A JAX `init_neural_field` pytree (numpy, or anything `np.asarray`
    takes) → the port's field on `device`, values bit for bit."""
    device = resolve_device(device)
    field = NeuralField(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in field.named_parameters():
            value = np.asarray(jax_leaf(params, name), np.float32)
            if value.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {value.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(value))
    return field.to(device)


def save_neural_npz(path: str, field: NeuralField) -> None:
    """The field in the JAX package's npz layout (`save_neural_npz`,
    `neural_field.py:97-114`), beside the PLY it renders."""
    cfg = field.cfg
    flat = {npz_key(name): p.detach().cpu().numpy()
            for name, p in field.named_parameters()}
    flat["__cfg__"] = np.asarray(
        [cfg.grid.num_levels, cfg.grid.level_dim, cfg.grid.base_resolution,
         cfg.grid.log2_hashmap_size, cfg.grid.desired_resolution,
         cfg.hidden_dim, cfg.geo_feat_dim, cfg.num_layers_sigma,
         cfg.hidden_dim_color, cfg.num_layers_color, cfg.sh_degree],
        np.int64)
    flat["__bound__"] = np.asarray(cfg.bound, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_neural_npz(path: str, device: str | torch.device = "cuda"
                    ) -> NeuralField:
    """An npz written by either package → the field on `device`; every
    array is shape-checked against the saved architecture."""
    device = resolve_device(device)
    data = np.load(path)
    c = [int(v) for v in data["__cfg__"]]
    cfg = NeuralFieldConfig(
        grid=HashGridConfig(*c[:5]), hidden_dim=c[5], geo_feat_dim=c[6],
        num_layers_sigma=c[7], hidden_dim_color=c[8], num_layers_color=c[9],
        sh_degree=c[10], bound=float(data["__bound__"]))
    field = NeuralField(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in field.named_parameters():
            value = data[npz_key(name)]
            if value.shape != tuple(p.shape):
                raise ValueError(f"neural npz leaf {npz_key(name)}: shape "
                                 f"{value.shape} != expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(np.asarray(value, np.float32)))
    return field.to(device)
