"""Render entry point: projection → tile binning → rasterize.

Counterpart of `sparse_view_3dgs_pack_tpu/renderer.py:27-272`. Inference
(render, eval, scoring) and training renders share `render_core`; a model
on a CUDA device goes through the hand-written kernels (`csrc/projection.cu`
forward and backward, `csrc/raster_fwd.cu`, and `csrc/raster_bwd.cu` for
the training render's backward), a model on the CPU through their plain
PyTorch versions. The stages run under the spans "render/<stage>"
(`utils/tracing.py`), which a profile reads (`chip_smoke.py`); a training
render's projection backward under "grad/projection"; an inference
frame's host work under "host/frame".
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .models.gaussians import GaussianModel
from .models.neural_field import NeuralField, gaussian_outputs
from .ops.binning import bin_gaussians
from .ops.projection import (Projected, ProjectionCamera, ProjectionInputs,
                             project_raw)
from .ops.raster import make_rasterizer
from .utils.tracing import grad_span, span

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
    # a camera of host arrays (the viewer's) is three copies to the card,
    # each of which waits for it
    host = not torch.is_tensor(cam.viewmat) or cam.viewmat.device != device
    with span("sync/camera", on=host):
        return (torch.as_tensor(cam.viewmat, **f32),
                torch.as_tensor(cam.full_proj, **f32),
                torch.as_tensor(cam.cam_center, **f32))


def project_params(params: dict, cam, width: int, height: int,
                   sh_degree_active: int, scaling_modifier: float = 1.0,
                   antialiasing: bool = False,
                   override_color: Optional[torch.Tensor] = None,
                   confidence=None, opacity_override=None) -> Projected:
    """The projection stage of `render_core` (its arguments of the same
    names), under the "render/projection" span; its backward, from the
    gradients of the outputs to those of the parameters it reads, under
    "grad/projection". A model on a CUDA device goes through
    `ProjectFunction` (`csrc/projection.cu`), one on the CPU through the
    plain composition (`ops/projection.py::project_raw`)."""
    xyz = params["xyz"]
    with span("render/projection"):
        viewmat, full_proj, cam_center = _camera_tensors(cam, xyz.device)
        g = grad_span("grad/projection")
        (xyz, log_scales, logit_opacity, quats, f_dc, f_rest, override_color,
         opacity_override) = g.inputs(
            xyz, params["scaling"], params["opacity"], params["rotation"],
            params["features_dc"], params["features_rest"], override_color,
            opacity_override)
        proj = project_raw(ProjectionInputs(
            xyz=xyz, scaling=log_scales, opacity=logit_opacity,
            rotation=quats, features_dc=f_dc, features_rest=f_rest,
            cam=ProjectionCamera(viewmat, full_proj, cam_center,
                                 float(cam.tan_fovx), float(cam.tan_fovy),
                                 width, height),
            sh_degree=sh_degree_active, scale_modifier=scaling_modifier,
            antialiasing=antialiasing, colors_precomp=override_color,
            confidence=confidence, opacity_override=opacity_override))
        means2d, depths, conics, colors, opacities = g.outputs(
            proj.means2d, proj.depths, proj.conics, proj.colors,
            proj.opacities)
        return proj._replace(means2d=means2d, depths=depths, conics=conics,
                             colors=colors, opacities=opacities)


def render_core(params: dict, exposure_mat: Optional[torch.Tensor], cam,
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
    cam: `data.cameras.CameraParams` (numpy arrays or tensors);
    `exposure_mat` (3, 4) is read only with `use_trained_exp`, and may be
    None without it.

    inference=False is the differentiable training render: 16×16 tiles and
    `RasterizeFunction`; the returned `viewspace_points` keeps its gradient.
    `confidence` (N,) scales each Gaussian's gradients (FSGS, JAX
    `renderer.py:71-89`): the straight-through p·c + detach(p·(1 − c)),
    whose forward rounds as the JAX one does. `opacity_override` (N,)
    takes the place of sigmoid(params["opacity"]): activated opacities
    (DNGaussian's neural opacity, or its depth pass's constant)."""
    proj = project_params(params, cam, width, height, sh_degree_active,
                          scaling_modifier, antialiasing, override_color,
                          confidence, opacity_override)
    means2d = proj.means2d
    if not inference and means2d.requires_grad:
        means2d.retain_grad()
    tx, ty = ((INFER_TILE_X, INFER_TILE_Y) if inference
              else (TRAIN_TILE_X, TRAIN_TILE_Y))
    with span("render/binning"):
        ba = bin_gaussians(means2d.detach(), proj.depths.detach(),
                           proj.rect_radii, width, height, tx, ty)
        # the backward's per-Gaussian order; a render never reads it
        order = (() if inference
                 else (ba.gaussian_slots, ba.gaussian_offsets))
    raster = make_rasterizer(width, height, proj.colors.shape[-1],
                             inference=inference, tile_x=tx, tile_y=ty)
    with span("render/rasterize"):
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
    `data.cameras.Camera` or `MiniCam`, under the "host/frame" span."""
    with span("host/frame"):
        device = model.xyz.device
        if sh_degree_active is None:
            sh_degree_active = model.max_sh_degree
        exposure_mat = model.exposure[min(exposure_idx,
                                          model.exposure.shape[0] - 1)]
        host_bg = (not torch.is_tensor(bg_color)
                   or bg_color.device != device)
        with span("sync/background", on=host_bg):
            bg = torch.as_tensor(bg_color, dtype=torch.float32,
                                 device=device)
        return render_core(model.params(), exposure_mat, camera.params(),
                           camera.width, camera.height, bg,
                           sh_degree_active, scaling_modifier, antialiasing,
                           use_trained_exp, override_color, inference=True)


@torch.no_grad()
def render_neural(model: GaussianModel, camera, bg_color, field: NeuralField,
                  sh_degree_active: Optional[int] = None,
                  scaling_modifier: float = 1.0,
                  antialiasing: bool = False) -> RenderResult:
    """DNGaussian inference render (JAX `render_neural`, `renderer.py:
    222-272`): each Gaussian's colour and opacity come from the neural
    field `field`, as in training (the reference reloads its GridRenderer
    to render, `DNGaussian/render.py:138-147`; the PLY alone holds the
    initial SH colours)."""
    device = model.xyz.device
    if sh_degree_active is None:
        sh_degree_active = model.max_sh_degree
    cam = camera.params()
    color, opacity = gaussian_outputs(
        field, model.xyz, model.opacity,
        torch.as_tensor(cam.cam_center, dtype=torch.float32, device=device))
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=device)
    return render_core(model.params(), None, cam,
                       camera.width, camera.height, bg, sh_degree_active,
                       scaling_modifier, antialiasing, False, color,
                       inference=True, opacity_override=opacity)
