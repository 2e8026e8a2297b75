"""Dense O(P·pixels) reference renderer — the correctness oracle.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/rasterize_ref.py`: every
Gaussian is evaluated at every pixel with the CUDA blending semantics. Only
for small scenes and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import _key_bits, depth_key, gaussian_rects, tile_grid
from .blending import alpha_from_power, blend_weights
from .projection import Projected


class RenderOutputs(NamedTuple):
    color: torch.Tensor      # (H, W, C)
    alpha: torch.Tensor      # (H, W)
    invdepth: torch.Tensor   # (H, W) expected inverse depth
    depth: torch.Tensor      # (H, W) expected depth


def rasterize_dense(proj: Projected, width: int, height: int,
                    background: torch.Tensor, tile_cull: bool = True,
                    match_binning_order: bool = True) -> RenderOutputs:
    """tile_cull=True: a Gaussian covers only pixels whose 16×16 tile meets
    its 3σ rect, the truncation the binning applies. match_binning_order=True
    blends in the binning's (truncated depth key, then index) order; False
    uses exact f32 depth order."""
    if match_binning_order:
        gx, gy = tile_grid(width, height)
        _, depth_bits = _key_bits(gx * gy)
        order = torch.argsort(depth_key(proj.depths, depth_bits), stable=True)
    else:
        order = torch.argsort(proj.depths, stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    colors = proj.colors[order]
    opac = proj.opacities[order]
    depths = proj.depths[order]
    live = (proj.radii[order] > 0) & torch.isfinite(depths)

    dev = means2d.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    dx = px[None, None, :] - means2d[:, 0, None, None]   # (P, 1, W)
    dy = py[None, :, None] - means2d[:, 1, None, None]   # (P, H, 1)
    a = conics[:, 0, None, None]
    b = conics[:, 1, None, None]
    c = conics[:, 2, None, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy  # (P, H, W)
    alphas = alpha_from_power(power, opac[:, None, None])
    alphas = torch.where(live[:, None, None], alphas,
                         torch.zeros_like(alphas))

    if tile_cull:
        min_x, max_x, min_y, max_y = gaussian_rects(
            means2d, proj.radii[order], width, height)
        tx = (torch.arange(width, device=dev) // 16)[None, None, :]
        ty = (torch.arange(height, device=dev) // 16)[None, :, None]
        in_rect = ((tx >= min_x[:, None, None]) & (tx < max_x[:, None, None])
                   & (ty >= min_y[:, None, None])
                   & (ty < max_y[:, None, None]))
        alphas = torch.where(in_rect, alphas, torch.zeros_like(alphas))

    alphas_hw = torch.movedim(alphas, 0, -1)               # (H, W, P)
    weights, log_t = blend_weights(alphas_hw, dim=-1)
    color = torch.einsum("hwp,pc->hwc", weights, colors)
    t_final = torch.exp(log_t)
    color = color + t_final[..., None] * background[None, None, :]
    safe_depth = torch.where(torch.isfinite(depths), depths,
                             torch.ones_like(depths))
    invdepth = torch.einsum("hwp,p->hw", weights, 1.0 / safe_depth)
    depth = torch.einsum("hwp,p->hw", weights, safe_depth)
    return RenderOutputs(color=color, alpha=1.0 - t_final,
                         invdepth=invdepth, depth=depth)
