"""Render entry point: projection → tile binning → rasterize.

Counterpart of `sparse_view_3dgs_pack_tpu/renderer.py:27-219` for
inference (render, eval, scoring). A model on a CUDA device goes through
the hand-written kernel `csrc/raster_fwd.cu`; a model on the CPU through
its plain PyTorch version. Training (the differentiable rasterizer) comes
with the backward kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .models.gaussians import GaussianModel
from .ops.binning import bin_gaussians
from .ops.projection import project_gaussians
from .ops.raster import make_rasterizer

# Inference tiles (JAX `renderer.py:112-113`): 32×16 cuts the pair count
# against 16×16 (less horizontal duplication) and halves the tile count.
INFER_TILE_X, INFER_TILE_Y = 32, 16


class RenderResult(NamedTuple):
    render: torch.Tensor          # (H, W, C), clamped to [0, 1] by default
    radii: torch.Tensor           # (N,) int32
    depth: torch.Tensor           # (H, W) expected inverse depth
    alpha: torch.Tensor           # (H, W)
    expected_depth: torch.Tensor  # (H, W)
    n_pairs: int                  # exact (tile, Gaussian) pair count


def _camera_tensors(cam, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(cam.viewmat, **f32),
            torch.as_tensor(cam.full_proj, **f32),
            torch.as_tensor(cam.cam_center, **f32))


def render_core(params: dict, exposure_mat: torch.Tensor, cam,
                width: int, height: int, bg_color: torch.Tensor,
                sh_degree_active: int,
                scaling_modifier: float = 1.0,
                antialiasing: bool = False,
                use_trained_exp: bool = False,
                override_color: Optional[torch.Tensor] = None,
                clamp: bool = True,
                inference: bool = True) -> RenderResult:
    """params: name → tensor (`GaussianModel.params()`), all on one device;
    cam: `data.cameras.CameraParams` (numpy)."""
    if not inference:
        raise NotImplementedError(
            "training renders need the backward kernel (ROADMAP Queue 2, "
            "K3), which is not ported yet")
    xyz = params["xyz"]
    viewmat, full_proj, cam_center = _camera_tensors(cam, xyz.device)
    scales = torch.exp(params["scaling"])
    opacity = torch.sigmoid(params["opacity"][:, 0])

    sh = None
    if override_color is None:
        sh = torch.cat([params["features_dc"], params["features_rest"]], 1)

    proj = project_gaussians(
        means3d=xyz, scales=scales, quats=params["rotation"],
        opacities=opacity, viewmat=viewmat, full_proj=full_proj,
        cam_center=cam_center, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        width=width, height=height, sh=sh, sh_degree=sh_degree_active,
        colors_precomp=override_color, scale_modifier=scaling_modifier,
        antialiasing=antialiasing)

    ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, width,
                       height, INFER_TILE_X, INFER_TILE_Y)
    raster = make_rasterizer(width, height, proj.colors.shape[-1],
                             inference=True, tile_x=INFER_TILE_X,
                             tile_y=INFER_TILE_Y)
    color, invdepth, depth, alpha = raster(
        proj.means2d.contiguous(), proj.depths.contiguous(),
        proj.conics.contiguous(), proj.colors.contiguous(),
        proj.opacities.contiguous(), ba.ids, ba.tile_starts, ba.tile_counts,
        bg_color)

    image = color
    if use_trained_exp:
        image = image @ exposure_mat[:3, :3] + exposure_mat[:3, 3]
    if clamp:
        image = torch.clamp(image, 0.0, 1.0)
    return RenderResult(render=image, radii=proj.radii, depth=invdepth,
                        alpha=alpha, expected_depth=depth,
                        n_pairs=ba.total_pairs)


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
