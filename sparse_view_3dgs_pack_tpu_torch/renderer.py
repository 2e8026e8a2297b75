"""Render entry point: projection → tile binning → rasterize.

Counterpart of `sparse_view_3dgs_pack_tpu/renderer.py:27-219`. Inference
(render, eval, scoring) and training renders share `render_core`; a model
on a CUDA device goes through the hand-written kernels (`csrc/raster_fwd.cu`,
and `csrc/raster_bwd.cu` for the training render's backward), a model on
the CPU through their plain PyTorch versions. The stages run under
`torch.profiler.record_function` ranges named "render/<stage>", which a
profile reads (`chip_smoke.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from .models.gaussians import GaussianModel
from .ops.binning import bin_gaussians
from .ops.projection import project_gaussians
from .ops.raster import make_rasterizer

# Inference tiles (JAX `renderer.py:112-113`): 32×16 cuts the pair count
# against 16×16 (less horizontal duplication) and halves the tile count.
INFER_TILE_X, INFER_TILE_Y = 32, 16
# Training tiles: the JAX default `RasterConfig(tile=16, train_tile_x=0)`
# (`ops/rasterize_tiles.py:65-73`, `renderer.py:114-116`).
TRAIN_TILE_X, TRAIN_TILE_Y = 16, 16


class RenderResult(NamedTuple):
    render: torch.Tensor          # (H, W, C), clamped to [0, 1] by default
    radii: torch.Tensor           # (N,) int32
    depth: torch.Tensor           # (H, W) expected inverse depth
    alpha: torch.Tensor           # (H, W)
    expected_depth: torch.Tensor  # (H, W)
    n_pairs: int                  # exact (tile, Gaussian) pair count
    # (N, 2) projected means in pixels; in a training render its `.grad`
    # after backward is the JAX `viewspace_offset` gradient (`step.py:226`)
    viewspace_points: Optional[torch.Tensor] = None


def _camera_tensors(cam, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(cam.viewmat, **f32),
            torch.as_tensor(cam.full_proj, **f32),
            torch.as_tensor(cam.cam_center, **f32))


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP Queue 1 "
        f"item {item})")


def render_core(params: dict, exposure_mat: torch.Tensor, cam,
                width: int, height: int, bg_color: torch.Tensor,
                sh_degree_active: int,
                scaling_modifier: float = 1.0,
                antialiasing: bool = False,
                use_trained_exp: bool = False,
                override_color: Optional[torch.Tensor] = None,
                clamp: bool = True,
                inference: bool = True,
                confidence=None,
                opacity_override=None) -> RenderResult:
    """params: name → tensor (`GaussianModel.params()`), all on one device;
    cam: `data.cameras.CameraParams` (numpy arrays or tensors).

    inference=False is the differentiable training render: 16×16 tiles and
    `RasterizeFunction`; the returned `viewspace_points` keeps its gradient.
    `confidence` and `opacity_override` serve FSGS and DNGaussian only."""
    if confidence is not None:
        _not_ported("the FSGS confidence gradient scale", 8)
    if opacity_override is not None:
        _not_ported("DNGaussian's opacity_override", 9)
    xyz = params["xyz"]
    with record_function("render/projection"):
        viewmat, full_proj, cam_center = _camera_tensors(cam, xyz.device)
        scales = torch.exp(params["scaling"])
        opacity = torch.sigmoid(params["opacity"][:, 0])

        sh = None
        if override_color is None:
            sh = torch.cat([params["features_dc"], params["features_rest"]],
                           1)

        proj = project_gaussians(
            means3d=xyz, scales=scales, quats=params["rotation"],
            opacities=opacity, viewmat=viewmat, full_proj=full_proj,
            cam_center=cam_center, tan_fovx=cam.tan_fovx,
            tan_fovy=cam.tan_fovy, width=width, height=height, sh=sh,
            sh_degree=sh_degree_active, colors_precomp=override_color,
            scale_modifier=scaling_modifier, antialiasing=antialiasing)

    means2d = proj.means2d
    if not inference and means2d.requires_grad:
        means2d.retain_grad()
    tx, ty = ((INFER_TILE_X, INFER_TILE_Y) if inference
              else (TRAIN_TILE_X, TRAIN_TILE_Y))
    with record_function("render/binning"):
        ba = bin_gaussians(means2d.detach(), proj.depths.detach(),
                           proj.rect_radii, width, height, tx, ty)
        # the backward's per-Gaussian order; a render never reads it
        order = (() if inference
                 else (ba.gaussian_slots, ba.gaussian_offsets))
    raster = make_rasterizer(width, height, proj.colors.shape[-1],
                             inference=inference, tile_x=tx, tile_y=ty)
    with record_function("render/rasterize"):
        color, invdepth, depth, alpha = raster(
            means2d.contiguous(), proj.depths.contiguous(),
            proj.conics.contiguous(), proj.colors.contiguous(),
            proj.opacities.contiguous(), ba.ids, ba.tile_starts,
            ba.tile_counts, bg_color, *order)

    image = color
    if use_trained_exp:
        image = image @ exposure_mat[:3, :3] + exposure_mat[:3, 3]
    if clamp:
        image = torch.clamp(image, 0.0, 1.0)
    return RenderResult(render=image, radii=proj.radii, depth=invdepth,
                        alpha=alpha, expected_depth=depth,
                        n_pairs=ba.total_pairs, viewspace_points=means2d)


@torch.no_grad()
def render(model: GaussianModel, camera, bg_color,
           sh_degree_active: Optional[int] = None,
           scaling_modifier: float = 1.0, antialiasing: bool = False,
           use_trained_exp: bool = False, exposure_idx: int = 0,
           override_color: Optional[torch.Tensor] = None) -> RenderResult:
    """Inference render of `model` (on its own device) from a
    `data.cameras.Camera` or `MiniCam`."""
    device = model.xyz.device
    if sh_degree_active is None:
        sh_degree_active = model.max_sh_degree
    exposure_mat = model.exposure[min(exposure_idx,
                                      model.exposure.shape[0] - 1)]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)
    return render_core(model.params(), exposure_mat, camera.params(),
                       camera.width, camera.height, bg, sh_degree_active,
                       scaling_modifier, antialiasing, use_trained_exp,
                       override_color, inference=True)
