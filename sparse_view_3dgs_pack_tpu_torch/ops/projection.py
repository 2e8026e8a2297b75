"""Gaussian preprocess: projection, EWA cov2D, conic, radius, SH color.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/projection.py:40-216`, batched
over all Gaussians as flat (P,)-vector arithmetic in the same operation
order, so the two agree to f32 rounding. Numerics follow the reference CUDA
preprocess (`forward.cu:74-260`): 1.3·tan_fov frustum clamp in the
Jacobian, +0.3 px dilation, optional antialiasing opacity rescale, 3σ
radius from the larger eigenvalue, near-cull at z ≤ 0.2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.sh import eval_sh
from .binning import gaussian_rects

# The 4×4 products below feed means2d at up to 1920 px: TF32's ~10 mantissa
# bits would move them by a sizeable fraction of a pixel. PyTorch's default
# is already False; it is set here so no caller can silently change it.
torch.backends.cuda.matmul.allow_tf32 = False

NEAR_CULL_Z = 0.2
DILATION = 0.3
CULL_TILE = 16  # the reference's getRect cull, whatever the raster tile


class Projected(NamedTuple):
    means2d: torch.Tensor     # (P, 2) pixel coords
    depths: torch.Tensor      # (P,) camera z; inf where culled
    radii: torch.Tensor       # (P,) int32 3σ pixel radius (0 = culled)
    conics: torch.Tensor      # (P, 3) inverse 2D covariance (a, b, c)
    colors: torch.Tensor      # (P, C)
    opacities: torch.Tensor   # (P,) after optional antialias scaling
    rect_radii: torch.Tensor  # (P, 2) int32 per-axis binning rect radius


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """Σ = (R S)(R S)ᵀ packed as (P, 6) upper-triangular
    [xx, xy, xz, yy, yz, zz]."""
    q = quats / torch.clamp(
        torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-24),
        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s2 = (scale_modifier * scales) ** 2

    def sig(i, k):
        return (R[i][0] * R[k][0] * s2[..., 0]
                + R[i][1] * R[k][1] * s2[..., 1]
                + R[i][2] * R[k][2] * s2[..., 2])

    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2),
                        sig(1, 1), sig(1, 2), sig(2, 2)], -1)


def _cov2d(p_view, cov3d, viewmat, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA projection of the 3D covariance to screen space. p_view: (P, 3).
    Returns the (xx, xy, yy) components before dilation."""
    tz = p_view[:, 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    # J rows: jx = [fx/z, 0, -fx·tx/z²], jy = [0, fy/z, -fy·ty/z²]
    jx0 = focal_x * inv_z
    jx2 = -focal_x * tx * inv_z * inv_z
    jy1 = focal_y * inv_z
    jy2 = -focal_y * ty * inv_z * inv_z

    W = viewmat[:3, :3]
    t0 = [jx0 * W[0, k] + jx2 * W[2, k] for k in range(3)]
    t1 = [jy1 * W[1, k] + jy2 * W[2, k] for k in range(3)]

    c00, c01, c02 = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    c11, c12, c22 = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    def sigma_dot(a, b):
        return (a[0] * (c00 * b[0] + c01 * b[1] + c02 * b[2])
                + a[1] * (c01 * b[0] + c11 * b[1] + c12 * b[2])
                + a[2] * (c02 * b[0] + c12 * b[1] + c22 * b[2]))

    return sigma_dot(t0, t0), sigma_dot(t0, t1), sigma_dot(t1, t1)


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means3d: torch.Tensor,           # (P, 3)
    scales: torch.Tensor,            # (P, 3) activated (exp applied)
    quats: torch.Tensor,             # (P, 4)
    opacities: torch.Tensor,         # (P,) activated (sigmoid applied)
    viewmat: torch.Tensor,           # (4, 4) world→cam
    full_proj: torch.Tensor,         # (4, 4) world→clip
    cam_center: torch.Tensor,        # (3,)
    tan_fovx: float, tan_fovy: float,
    width: int, height: int,
    sh: Optional[torch.Tensor] = None,              # (P, K, C)
    sh_degree: int = 0,
    colors_precomp: Optional[torch.Tensor] = None,  # (P, C)
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
) -> Projected:
    tan_fovx = float(tan_fovx)
    tan_fovy = float(tan_fovy)
    P = means3d.shape[0]
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    homog = torch.cat([means3d, means3d.new_ones((P, 1))], dim=1)
    p_view = homog @ viewmat.T
    p_hom = homog @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    in_front = p_view[:, 2] > NEAR_CULL_Z
    safe_z = torch.where(in_front, p_view[:, 2], torch.ones_like(p_w))
    p_view_safe = torch.stack([p_view[:, 0], p_view[:, 1], safe_z], dim=1)

    cov3d = compute_cov3d(scales, quats, scale_modifier)
    cxx, cxy, cyy = _cov2d(p_view_safe, cov3d, viewmat,
                           focal_x, focal_y, tan_fovx, tan_fovy)

    det_cov = cxx * cyy - cxy * cxy
    cxx_d = cxx + DILATION
    cyy_d = cyy + DILATION
    det_dil = cxx_d * cyy_d - cxy * cxy
    if antialiasing:
        h_scale = torch.sqrt(torch.clamp(det_cov / det_dil, min=2.5e-5))
    else:
        h_scale = torch.ones_like(det_cov)

    valid = in_front & (det_dil != 0.0)
    det_inv = 1.0 / torch.where(det_dil == 0, torch.ones_like(det_dil),
                                det_dil)
    conics = torch.stack([cyy_d * det_inv, -cxy * det_inv, cxx_d * det_inv],
                         -1)

    mid = 0.5 * (cxx_d + cyy_d)
    disc = torch.sqrt(torch.clamp(mid * mid - det_dil, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                       mid - disc)))

    means2d = torch.stack([ndc2pix(p_proj[:, 0], width),
                           ndc2pix(p_proj[:, 1], height)], -1)

    # cull Gaussians whose 16-px tile rect is empty (reference getRect)
    min_x, max_x, min_y, max_y = gaussian_rects(means2d, radius, width,
                                                height, CULL_TILE, CULL_TILE)
    valid = valid & ((max_x - min_x) * (max_y - min_y) > 0)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        dirs = means3d - cam_center[None, :]
        dirs = dirs / torch.clamp(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
        colors = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)

    zero = torch.zeros_like(radius)
    # NaN/Inf radii (corrupt params) would cast to garbage ints that claim
    # every tile: cull them instead
    radii = torch.where(valid & torch.isfinite(radius),
                        torch.clamp(radius, max=1e7), zero).to(torch.int32)

    # Per-axis binning rect: the AABB of the alpha >= 1/255 level-set
    # ellipse, clamped to the 3σ square (see the JAX module for why the
    # render output is unchanged). +1 px absorbs f32 rounding.
    op_final = torch.where(valid, opacities * h_scale, zero)
    two_l = 2.0 * torch.log(torch.clamp(op_final, min=1e-12) * 255.0)
    rx = torch.ceil(torch.sqrt(torch.clamp(two_l * cxx_d, min=0.0))) + 1.0
    ry = torch.ceil(torch.sqrt(torch.clamp(two_l * cyy_d, min=0.0))) + 1.0
    rect = torch.stack([torch.minimum(radius, rx), torch.minimum(radius, ry)],
                       -1)
    keep = (valid & (op_final >= 1.0 / 255.0) & torch.isfinite(radius)
            & torch.isfinite(rect[:, 0]) & torch.isfinite(rect[:, 1]))
    rect_radii = torch.where(keep[:, None], torch.clamp(rect, max=1e7),
                             torch.zeros_like(rect)).to(torch.int32)
    return Projected(
        means2d=means2d,
        depths=torch.where(valid, p_view[:, 2],
                           torch.full_like(p_w, float("inf"))),
        radii=radii,
        conics=conics,
        colors=colors,
        opacities=op_final,
        rect_radii=rect_radii,
    )
