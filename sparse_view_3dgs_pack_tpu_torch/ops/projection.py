"""Gaussian preprocess: projection, EWA cov2D, conic, radius, SH color.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/projection.py:40-216`, batched
over all Gaussians as flat (P,)-vector arithmetic in the same operation
order, so the two agree to f32 rounding. Numerics follow the reference CUDA
preprocess (`forward.cu:74-260`): 1.3·tan_fov frustum clamp in the
Jacobian, +0.3 px dilation, optional antialiasing opacity rescale, 3σ
radius from the larger eigenvalue, near-cull at z ≤ 0.2.

The whole per-Gaussian projection from the raw parameters (log scales,
logit opacity, unnormalised quaternion, the two SH feature blocks) is one
`torch.autograd.Function` on CUDA tensors, `ProjectFunction`: a
hand-written forward and backward kernel (`csrc/projection.cu`) that save
only their inputs. Each wrapper dispatches on the device of its tensors
and has no fallback from one to the other:
  project_raw       ProjectFunction      | project_raw_torch (autograd)
  project_forward   project_fwd_kernel   | project_raw_torch
  project_backward  project_bwd_kernel   | project_backward_torch
`project_forward.launches` and `project_backward.launches` count kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils import sh as sh_utils
from ..utils.sh import eval_sh
from ._build import load
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


# ---------------------------------------------------------------------------
# From the raw parameters: the plain composition, the kernels, the Function


class ProjectionCamera(NamedTuple):
    """One view as the projection reads it."""
    viewmat: torch.Tensor     # (4, 4) world→cam, on the Gaussians' device
    full_proj: torch.Tensor   # (4, 4) world→clip
    cam_center: torch.Tensor  # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class ProjectionInputs(NamedTuple):
    """What the projection reads of the model and the view."""
    xyz: torch.Tensor            # (P, 3)
    scaling: torch.Tensor        # (P, 3) log scales
    opacity: torch.Tensor        # (P, 1) logit opacity
    rotation: torch.Tensor       # (P, 4) quaternion (w, x, y, z)
    features_dc: torch.Tensor    # (P, 1, C)
    features_rest: torch.Tensor  # (P, K - 1, C)
    cam: ProjectionCamera
    sh_degree: int
    scale_modifier: float = 1.0
    antialiasing: bool = False
    # (P, C) colours in place of the SH ones (the features are not read)
    colors_precomp: Optional[torch.Tensor] = None
    # (P,) FSGS's per-Gaussian gradient scale: the straight-through
    # p·c + detach(p·(1 − c)) of xyz, scales, rotation, opacity and SH
    confidence: Optional[torch.Tensor] = None
    # (P,) activated opacities in place of sigmoid(opacity)
    opacity_override: Optional[torch.Tensor] = None

    @property
    def channels(self) -> int:
        c = (self.colors_precomp if self.colors_precomp is not None
             else self.features_dc)
        return c.shape[-1]


class ProjectionGrads(NamedTuple):
    """Gradients of the differentiable inputs; None for an input that is
    not read (the features under colors_precomp, the logit opacity under
    opacity_override) or not given."""
    xyz: torch.Tensor
    scaling: torch.Tensor
    opacity: Optional[torch.Tensor]
    rotation: torch.Tensor
    features_dc: Optional[torch.Tensor]
    features_rest: Optional[torch.Tensor]
    colors_precomp: Optional[torch.Tensor]
    opacity_override: Optional[torch.Tensor]


def project_raw_torch(inp: ProjectionInputs) -> Projected:
    """The plain composition, differentiable by autograd: exp, sigmoid (or
    the override), FSGS's confidence, the SH concatenation, then
    `project_gaussians`."""
    xyz, quats = inp.xyz, inp.rotation
    scales = torch.exp(inp.scaling)
    opacity = (torch.sigmoid(inp.opacity[:, 0])
               if inp.opacity_override is None else inp.opacity_override)
    confidence = inp.confidence

    if confidence is not None:
        def scale_grad(p):
            c = confidence.reshape((-1,) + (1,) * (p.ndim - 1))
            return p * c + (p * (1.0 - c)).detach()
        xyz, scales, quats, opacity = (scale_grad(p) for p in
                                       (xyz, scales, quats, opacity))

    sh = None
    if inp.colors_precomp is None:
        sh = torch.cat([inp.features_dc, inp.features_rest], 1)
        if confidence is not None:
            sh = scale_grad(sh)

    cam = inp.cam
    return project_gaussians(
        means3d=xyz, scales=scales, quats=quats, opacities=opacity,
        viewmat=cam.viewmat, full_proj=cam.full_proj,
        cam_center=cam.cam_center, tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=cam.width, height=cam.height, sh=sh,
        sh_degree=inp.sh_degree, colors_precomp=inp.colors_precomp,
        scale_modifier=inp.scale_modifier, antialiasing=inp.antialiasing)


def project_raw(inp: ProjectionInputs) -> Projected:
    """The projection of `inp`, differentiable in its tensors: on CUDA
    tensors `ProjectFunction` (the two kernels), otherwise the plain
    composition under autograd."""
    if inp.xyz.device.type == "cuda":
        return Projected(*ProjectFunction.apply(
            inp, inp.xyz, inp.scaling, inp.opacity, inp.rotation,
            inp.features_dc, inp.features_rest, inp.colors_precomp,
            inp.opacity_override))
    return project_raw_torch(inp)


def _check_inputs(inp: ProjectionInputs) -> ProjectionInputs:
    """`inp` with its tensors contiguous, or ValueError where the kernels
    do not take it."""
    P, C = inp.xyz.shape[0], inp.channels
    n_rest = inp.features_rest.shape[1]
    precomp = inp.colors_precomp is not None
    if C not in (1, 3):
        raise ValueError(f"{C} colour channels: the projection kernels take "
                         "1 or 3")
    if not 0 <= inp.sh_degree <= 3 or n_rest > 15 or (
            not precomp and (inp.sh_degree + 1) ** 2 > 1 + n_rest):
        raise ValueError(f"SH degree {inp.sh_degree} with {n_rest + 1} "
                         "coefficients")
    cam = inp.cam
    shapes = {"xyz": (P, 3), "scaling": (P, 3), "rotation": (P, 4),
              "confidence": (P,), "opacity_override": (P,)}
    shapes["opacity"] = (P, 1) if inp.opacity_override is None else None
    if precomp:
        shapes["colors_precomp"] = (P, C)
    else:
        shapes.update(features_dc=(P, 1, C), features_rest=(P, n_rest, C))
    fields = {}
    for name, shape in shapes.items():
        t = getattr(inp, name)
        if t is None or shape is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != inp.xyz.device):
            raise ValueError(f"{name}: expected float32 {shape} on "
                             f"{inp.xyz.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        fields[name] = t.contiguous()
    for name, t, shape in (("viewmat", cam.viewmat, (4, 4)),
                           ("full_proj", cam.full_proj, (4, 4)),
                           ("cam_center", cam.cam_center, (3,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != inp.xyz.device):
            raise ValueError(f"camera {name}: expected float32 {shape} on "
                             f"{inp.xyz.device}")
    cam = cam._replace(viewmat=cam.viewmat.contiguous(),
                       full_proj=cam.full_proj.contiguous(),
                       cam_center=cam.cam_center.contiguous(),
                       tan_fovx=float(cam.tan_fovx),
                       tan_fovy=float(cam.tan_fovy))
    return inp._replace(cam=cam, **fields)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_args(inp: ProjectionInputs) -> tuple:
    """(input pointers, ints, floats) of both kernels' C entry points."""
    cam = inp.cam
    ptrs = (inp.xyz, inp.scaling,
            inp.opacity if inp.opacity_override is None
            else inp.opacity_override,
            inp.rotation, inp.features_dc, inp.features_rest,
            inp.colors_precomp, inp.confidence, cam.viewmat, cam.full_proj,
            cam.cam_center)
    ints = (inp.xyz.shape[0], inp.channels, inp.features_rest.shape[1],
            inp.sh_degree, cam.width, cam.height,
            int(inp.opacity_override is not None), int(inp.antialiasing))
    # the plain path's host-side numbers, rounded to f32 where it meets a
    # tensor (focal lengths, the 1.3·tan_fov clamp)
    floats = (cam.width / (2.0 * cam.tan_fovx),
              cam.height / (2.0 * cam.tan_fovy), 1.3 * cam.tan_fovx,
              1.3 * cam.tan_fovy, float(inp.scale_modifier))
    return tuple(_ptr(t) for t in ptrs), ints, floats


def _bind(name: str, n_ptrs: int, n_ints: int, n_floats: int):
    fn = getattr(load("projection"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def project_forward(inp: ProjectionInputs) -> Projected:
    """The projection's values, without autograd. CUDA tensors launch
    `project_fwd_kernel`; CPU tensors run the plain composition.
    `project_forward.launches` counts kernel launches."""
    if inp.xyz.device.type == "cuda":
        return _project_forward_cuda(_check_inputs(inp))
    with torch.no_grad():
        return project_raw_torch(inp)


project_forward.launches = 0


def _project_forward_cuda(inp: ProjectionInputs) -> Projected:
    P, C, dev = inp.xyz.shape[0], inp.channels, inp.xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = Projected(
        means2d=torch.empty((P, 2), **f32), depths=torch.empty(P, **f32),
        radii=torch.empty(P, dtype=torch.int32, device=dev),
        conics=torch.empty((P, 3), **f32), colors=torch.empty((P, C), **f32),
        opacities=torch.empty(P, **f32),
        rect_radii=torch.empty((P, 2), dtype=torch.int32, device=dev))
    ptrs, ints, floats = _kernel_args(inp)
    outs = (out.means2d, out.depths, out.conics, out.colors, out.opacities,
            out.radii, out.rect_radii)
    fn = _bind("project_fwd", len(ptrs) + len(outs), len(ints), len(floats))
    with torch.cuda.device(dev):
        err = fn(*ptrs, *(t.data_ptr() for t in outs), *ints, *floats,
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"project_fwd launch failed: cudaError {err}")
    project_forward.launches += 1
    return out


def project_backward(inp: ProjectionInputs, cot: tuple) -> ProjectionGrads:
    """Gradients of `inp`'s differentiable tensors from the cotangents
    `cot` = (means2d (P, 2), depths (P,), conics (P, 3), colors (P, C),
    opacities (P,)). CUDA tensors launch `project_bwd_kernel`; CPU tensors
    run `project_backward_torch`. `project_backward.launches` counts
    kernel launches."""
    if inp.xyz.device.type == "cuda":
        return _project_backward_cuda(_check_inputs(inp), cot)
    return project_backward_torch(inp, cot)


project_backward.launches = 0


def _rows(g: torch.Tensor, shape: tuple, name: str):
    """A cotangent and its row stride in floats: rows may be spaced (the
    rasterizer's per-Gaussian gradients are column slices of one array),
    a row's values must be adjacent."""
    if g.dtype != torch.float32 or tuple(g.shape) != shape:
        raise ValueError(f"cotangent of {name}: expected float32 {shape}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    if g.ndim == 2 and g.stride(1) != 1:
        g = g.contiguous()
    return g, g.stride(0)


def _project_backward_cuda(inp: ProjectionInputs,
                           cot: tuple) -> ProjectionGrads:
    P, C, dev = inp.xyz.shape[0], inp.channels, inp.xyz.device
    names = ("means2d", "depths", "conics", "colors", "opacities")
    shapes = ((P, 2), (P,), (P, 3), (P, C), (P,))
    rows = [_rows(g, s, n) for g, s, n in zip(cot, shapes, names)]
    empty = lambda t: None if t is None else torch.empty_like(t)
    override = inp.opacity_override is not None
    precomp = inp.colors_precomp is not None
    grads = ProjectionGrads(
        xyz=empty(inp.xyz), scaling=empty(inp.scaling),
        opacity=None if override else empty(inp.opacity),
        rotation=empty(inp.rotation),
        features_dc=None if precomp else empty(inp.features_dc),
        features_rest=None if precomp else empty(inp.features_rest),
        colors_precomp=empty(inp.colors_precomp),
        opacity_override=empty(inp.opacity_override))
    ptrs, ints, floats = _kernel_args(inp)
    outs = (grads.xyz, grads.scaling,
            grads.opacity_override if override else grads.opacity,
            grads.rotation, grads.features_dc, grads.features_rest,
            grads.colors_precomp)
    fn = _bind("project_bwd", len(ptrs) + len(rows) + len(outs),
               len(ints) + len(rows), len(floats))
    with torch.cuda.device(dev):
        err = fn(*ptrs, *(g.data_ptr() for g, _ in rows),
                 *(_ptr(t) for t in outs), *ints, *(s for _, s in rows),
                 *floats, _stream(dev))
    if err != 0:
        raise RuntimeError(f"project_bwd launch failed: cudaError {err}")
    project_backward.launches += 1
    return grads


class ProjectFunction(torch.autograd.Function):
    """The projection from the raw parameters, forward and backward each
    one kernel on CUDA tensors (`project_forward`, `project_backward`).
    Only the inputs are saved: the backward recomputes each Gaussian's
    forward. Its gradients are those autograd gives the plain composition
    (`project_raw_torch`), masks included: `valid` on depths and
    opacities, `in_front` on the camera z, the Jacobian's clamp, the SH
    colour's clamp at 0; `radii` and `rect_radii` get none. The tensors
    are passed beside `inp` so that autograd sees them; `confidence` takes
    no gradient."""

    @staticmethod
    def forward(ctx, inp, xyz, scaling, opacity, rotation, features_dc,
                features_rest, colors_precomp, opacity_override):
        if inp.confidence is not None and inp.confidence.requires_grad:
            raise ValueError("confidence takes no gradient")
        inp = inp._replace(
            xyz=xyz, scaling=scaling, opacity=opacity, rotation=rotation,
            features_dc=features_dc, features_rest=features_rest,
            colors_precomp=colors_precomp, opacity_override=opacity_override)
        out = project_forward(inp)
        ctx.save_for_backward(inp.xyz, inp.scaling, inp.opacity,
                              inp.rotation, inp.features_dc,
                              inp.features_rest, inp.colors_precomp,
                              inp.opacity_override)
        ctx.inp = inp._replace(xyz=None, scaling=None, opacity=None,
                               rotation=None, features_dc=None,
                               features_rest=None, colors_precomp=None,
                               opacity_override=None)
        ctx.mark_non_differentiable(out.radii, out.rect_radii)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_means2d, g_depths, _g_radii, g_conics, g_colors,
                 g_opacities, _g_rect):
        (xyz, scaling, opacity, rotation, f_dc, f_rest, precomp,
         override) = ctx.saved_tensors
        inp = ctx.inp._replace(
            xyz=xyz, scaling=scaling, opacity=opacity, rotation=rotation,
            features_dc=f_dc, features_rest=f_rest, colors_precomp=precomp,
            opacity_override=override)
        g = project_backward(inp, (g_means2d, g_depths, g_conics, g_colors,
                                   g_opacities))
        need = ctx.needs_input_grad
        return (None,) + tuple(
            t if n else None for t, n in zip(
                (g.xyz, g.scaling, g.opacity, g.rotation, g.features_dc,
                 g.features_rest, g.colors_precomp, g.opacity_override),
                need[1:]))


_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _sh_basis(deg: int, x, y, z) -> list:
    """[(value, (d/dx, d/dy, d/dz))] of the SH basis functions of bands
    1..deg at the unit direction (x, y, z); values rounded as `eval_sh`
    rounds them."""
    C1, C2, C3 = sh_utils.C1, sh_utils.C2, sh_utils.C3
    out = [(-(C1 * y), (0.0, -C1, 0.0)), (C1 * z, (0.0, 0.0, C1)),
           (-(C1 * x), (-C1, 0.0, 0.0))]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            (C2[0] * xy, (C2[0] * y, C2[0] * x, 0.0)),
            (C2[1] * yz, (0.0, C2[1] * z, C2[1] * y)),
            (C2[2] * (2.0 * zz - xx - yy),
             (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z)),
            (C2[3] * xz, (C2[3] * z, 0.0, C2[3] * x)),
            (C2[4] * (xx - yy), (2.0 * C2[4] * x, -2.0 * C2[4] * y, 0.0))]
        if deg > 2:
            out += [
                (C3[0] * y * (3.0 * xx - yy),
                 (6.0 * C3[0] * xy, 3.0 * C3[0] * (xx - yy), 0.0)),
                (C3[1] * xy * z,
                 (C3[1] * yz, C3[1] * xz, C3[1] * xy)),
                (C3[2] * y * (4.0 * zz - xx - yy),
                 (-2.0 * C3[2] * xy, C3[2] * (4.0 * zz - xx - 3.0 * yy),
                  8.0 * C3[2] * yz)),
                (C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 (-6.0 * C3[3] * xz, -6.0 * C3[3] * yz,
                  C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy))),
                (C3[4] * x * (4.0 * zz - xx - yy),
                 (C3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * C3[4] * xy,
                  8.0 * C3[4] * xz)),
                (C3[5] * z * (xx - yy),
                 (2.0 * C3[5] * xz, -2.0 * C3[5] * yz, C3[5] * (xx - yy))),
                (C3[6] * x * (xx - 3.0 * yy),
                 (3.0 * C3[6] * (xx - yy), -6.0 * C3[6] * xy, 0.0))]
    return out


def project_backward_torch(inp: ProjectionInputs,
                           cot: tuple) -> ProjectionGrads:
    """Plain version of `project_bwd_kernel`: each Gaussian's forward
    recomputed, then the chain rule written out, in the kernel's order.
    `cot` as `project_backward`'s. Its gradients are autograd's of
    `project_raw_torch` up to f32 rounding (tests/test_torch_projection_
    grad.py)."""
    g_m2d, g_dep, g_con, g_col, g_opa = cot
    cam = inp.cam
    V, F = cam.viewmat, cam.full_proj
    W, H = cam.width, cam.height
    tan_x, tan_y = float(cam.tan_fovx), float(cam.tan_fovy)
    fx, fy = W / (2.0 * tan_x), H / (2.0 * tan_y)
    lim_x, lim_y = 1.3 * tan_x, 1.3 * tan_y
    sm = inp.scale_modifier
    zero = torch.zeros_like(inp.xyz[:, 0])

    # activations and FSGS's confidence (its forward rounds p·c + p·(1 − c))
    s_exp = torch.exp(inp.scaling)
    override = inp.opacity_override is not None
    sig = None if override else torch.sigmoid(inp.opacity[:, 0])
    op = inp.opacity_override if override else sig
    m, s, q = inp.xyz, s_exp, inp.rotation
    conf = inp.confidence
    if conf is not None:
        omc = 1.0 - conf
        m, s, q = (v * conf[:, None] + v * omc[:, None] for v in (m, s, q))
        op = op * conf + op * omc
    m, s, q = m.unbind(1), s.unbind(1), q.unbind(1)

    # forward: camera space, clip space, near cull (the kernel fuses the
    # second and third products, and sums the two norms below in another
    # order, as cuBLAS and PyTorch's reductions do on the card)
    pv = [m[0] * V[i, 0] + m[1] * V[i, 1] + m[2] * V[i, 2] + V[i, 3]
          for i in range(3)]
    ph = [m[0] * F[i, 0] + m[1] * F[i, 1] + m[2] * F[i, 2] + F[i, 3]
          for i in range(4)]
    pw = 1.0 / (ph[3] + 1e-7)
    in_front = pv[2] > NEAR_CULL_Z
    tz = torch.where(in_front, pv[2], torch.ones_like(pv[2]))
    # forward: the 3D covariance
    ss = torch.sqrt((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3])
                    + 1e-24)
    n = torch.clamp(ss, min=1e-12)
    w, x, y, z = (v / n for v in q)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    sms = [sm * v for v in s]
    s2 = [v * v for v in sms]
    cov = {(a, b): (R[a][0] * R[b][0] * s2[0] + R[a][1] * R[b][1] * s2[1]
                    + R[a][2] * R[b][2] * s2[2]) for a, b in _PAIRS}
    S = lambda a, b: cov[(min(a, b), max(a, b))]
    # forward: the EWA Jacobian and the 2D covariance
    rx = pv[0] / tz
    ry = pv[1] / tz
    cx = torch.clamp(rx, -lim_x, lim_x)
    cy = torch.clamp(ry, -lim_y, lim_y)
    tx, ty = cx * tz, cy * tz
    iz = 1.0 / tz
    jx0, jx2 = fx * iz, -fx * tx * iz * iz
    jy1, jy2 = fy * iz, -fy * ty * iz * iz
    t0 = [jx0 * V[0, k] + jx2 * V[2, k] for k in range(3)]
    t1 = [jy1 * V[1, k] + jy2 * V[2, k] for k in range(3)]
    St0 = [S(a, 0) * t0[0] + S(a, 1) * t0[1] + S(a, 2) * t0[2]
           for a in range(3)]
    St1 = [S(a, 0) * t1[0] + S(a, 1) * t1[1] + S(a, 2) * t1[2]
           for a in range(3)]
    cxx = t0[0] * St0[0] + t0[1] * St0[1] + t0[2] * St0[2]
    cxy = t0[0] * St1[0] + t0[1] * St1[1] + t0[2] * St1[2]
    cyy = t1[0] * St1[0] + t1[1] * St1[1] + t1[2] * St1[2]
    det_cov = cxx * cyy - cxy * cxy
    cxd, cyd = cxx + DILATION, cyy + DILATION
    det_dil = cxd * cyd - cxy * cxy
    det_inv = 1.0 / torch.where(det_dil == 0, torch.ones_like(det_dil),
                                det_dil)
    # forward: the radius and the tile-rect cull, for `valid`
    mid = 0.5 * (cxd + cyd)
    disc = torch.sqrt(torch.clamp(mid * mid - det_dil, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                       mid - disc)))
    means2d = torch.stack([ndc2pix(ph[0] * pw, W), ndc2pix(ph[1] * pw, H)],
                          -1)
    min_x, max_x, min_y, max_y = gaussian_rects(means2d, radius, W, H,
                                                CULL_TILE, CULL_TILE)
    valid = (in_front & (det_dil != 0.0)
             & ((max_x - min_x) * (max_y - min_y) > 0))

    # means2d ← clip space
    g_px = g_m2d[:, 0] * 0.5 * W
    g_py = g_m2d[:, 1] * 0.5 * H
    g_pw = g_px * ph[0] + g_py * ph[1]
    g_ph = [g_px * pw, g_py * pw, None, -g_pw * (pw * pw)]
    g_m = [g_ph[0] * F[0, k] + g_ph[1] * F[1, k] + g_ph[3] * F[3, k]
           for k in range(3)]
    # conics, opacities (antialiasing's h too), depths ← the 2D covariance
    g_cyd = g_con[:, 0] * det_inv
    g_cxy = -(g_con[:, 1] * det_inv)
    g_cxd = g_con[:, 2] * det_inv
    g_det_inv = g_con[:, 0] * cyd - g_con[:, 1] * cxy + g_con[:, 2] * cxd
    g_det_dil = torch.where(det_dil == 0, zero,
                            -g_det_inv * (det_inv * det_inv))
    g_cxx = g_cyy = zero
    if inp.antialiasing:
        ratio = det_cov / det_dil
        h = torch.sqrt(torch.clamp(ratio, min=2.5e-5))
        g_h = torch.where(valid, g_opa * op, zero)
        g_ratio = torch.where(ratio >= 2.5e-5, g_h / (2.0 * h), zero)
        g_det_cov = g_ratio / det_dil
        g_det_dil = g_det_dil - g_ratio * (ratio / det_dil)
        g_cxx = g_det_cov * cyy
        g_cyy = g_det_cov * cxx
        g_cxy = g_cxy - 2.0 * (g_det_cov * cxy)
    else:
        h = torch.ones_like(zero)
    g_op = torch.where(valid, g_opa * h, zero)
    g_cxx = g_cxx + g_cxd + g_det_dil * cyd
    g_cyy = g_cyy + g_cyd + g_det_dil * cxd
    g_cxy = g_cxy - 2.0 * (g_det_dil * cxy)
    # the 2D covariance ← the Jacobian rows and the 3D covariance
    g_t0 = [2.0 * g_cxx * St0[k] + g_cxy * St1[k] for k in range(3)]
    g_t1 = [2.0 * g_cyy * St1[k] + g_cxy * St0[k] for k in range(3)]
    g_cov = {}
    for a, b in _PAIRS:
        if a == b:
            g_cov[(a, b)] = (g_cxx * t0[a] * t0[a] + g_cxy * t0[a] * t1[a]
                             + g_cyy * t1[a] * t1[a])
        else:
            g_cov[(a, b)] = (2.0 * g_cxx * t0[a] * t0[b]
                             + g_cxy * (t0[a] * t1[b] + t0[b] * t1[a])
                             + 2.0 * g_cyy * t1[a] * t1[b])
    # the Jacobian ← camera space (the clamp passes x and y inside it)
    g_jx0 = g_t0[0] * V[0, 0] + g_t0[1] * V[0, 1] + g_t0[2] * V[0, 2]
    g_jx2 = g_t0[0] * V[2, 0] + g_t0[1] * V[2, 1] + g_t0[2] * V[2, 2]
    g_jy1 = g_t1[0] * V[1, 0] + g_t1[1] * V[1, 1] + g_t1[2] * V[1, 2]
    g_jy2 = g_t1[0] * V[2, 0] + g_t1[1] * V[2, 1] + g_t1[2] * V[2, 2]
    g_iz = (g_jx0 * fx + g_jy1 * fy + 2.0 * g_jx2 * (-fx * tx) * iz
            + 2.0 * g_jy2 * (-fy * ty) * iz)
    g_tx = g_jx2 * (-fx) * iz * iz
    g_ty = g_jy2 * (-fy) * iz * iz
    g_tz = -g_iz * (iz * iz) + g_tx * cx + g_ty * cy
    g_rx = torch.where((rx >= -lim_x) & (rx <= lim_x), g_tx * tz, zero)
    g_ry = torch.where((ry >= -lim_y) & (ry <= lim_y), g_ty * tz, zero)
    g_pv = [g_rx / tz, g_ry / tz, torch.where(valid, g_dep, zero)]
    g_tz = g_tz - g_rx * (rx / tz) - g_ry * (ry / tz)
    g_pv[2] = g_pv[2] + torch.where(in_front, g_tz, zero)
    g_m = [g_m[k] + g_pv[0] * V[0, k] + g_pv[1] * V[1, k] + g_pv[2] * V[2, k]
           for k in range(3)]
    # the 3D covariance ← scales and the rotation
    M = [[(2.0 * g_cov[(a, a)] if a == b else g_cov[(min(a, b), max(a, b))])
          for b in range(3)] for a in range(3)]
    g_s = [sum(g_cov[(a, b)] * R[a][j] * R[b][j] for a, b in _PAIRS)
           * 2.0 * sms[j] * sm for j in range(3)]
    G = [[s2[j] * (M[a][0] * R[0][j] + M[a][1] * R[1][j]
                   + M[a][2] * R[2][j]) for j in range(3)] for a in range(3)]
    g_qn = [
        2.0 * (-z * G[0][1] + y * G[0][2] + z * G[1][0] - x * G[1][2]
               - y * G[2][0] + x * G[2][1]),
        -4.0 * x * (G[1][1] + G[2][2]) + 2.0 * (
            y * (G[0][1] + G[1][0]) + z * (G[0][2] + G[2][0])
            + w * (G[2][1] - G[1][2])),
        -4.0 * y * (G[0][0] + G[2][2]) + 2.0 * (
            x * (G[0][1] + G[1][0]) + w * (G[0][2] - G[2][0])
            + z * (G[1][2] + G[2][1])),
        -4.0 * z * (G[0][0] + G[1][1]) + 2.0 * (
            w * (G[1][0] - G[0][1]) + x * (G[0][2] + G[2][0])
            + y * (G[1][2] + G[2][1]))]
    dot = (g_qn[0] * w + g_qn[1] * x + g_qn[2] * y + g_qn[3] * z)
    g_ss = torch.where(ss >= 1e-12, -dot / n, zero)
    g_q = [g_qn[k] / n + q[k] * (g_ss / ss) for k in range(4)]

    # colours: the SH coefficients and the view direction
    C = inp.channels
    g_sh = g_precomp = None
    if inp.colors_precomp is not None:
        g_precomp = g_col
    else:
        sh = torch.cat([inp.features_dc, inp.features_rest], 1)
        if conf is not None:
            sh = sh * conf[:, None, None] + sh * omc[:, None, None]
        d = [m[k] - cam.cam_center[k] for k in range(3)]
        norm = torch.sqrt((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1])
        nrm = torch.clamp(norm, min=1e-12)
        dn = [v / nrm for v in d]
        basis = _sh_basis(inp.sh_degree, *dn) if inp.sh_degree else []
        v = sh_utils.C0 * sh[:, 0]
        for k, (b, _) in enumerate(basis, 1):
            v = v + b[:, None] * sh[:, k]
        g_v = torch.where(v + 0.5 >= 0.0, g_col, torch.zeros_like(g_col))
        g_sh = torch.zeros_like(sh)
        g_sh[:, 0] = sh_utils.C0 * g_v
        g_dn = [zero, zero, zero]
        for k, (b, db) in enumerate(basis, 1):
            g_sh[:, k] = b[:, None] * g_v
            wk = (g_v * sh[:, k]).sum(-1)
            g_dn = [g_dn[i] + wk * db[i] for i in range(3)]
        if basis:
            g_dot = g_dn[0] * dn[0] + g_dn[1] * dn[1] + g_dn[2] * dn[2]
            g_nrm = torch.where(norm >= 1e-12, -g_dot / nrm, zero)
            g_norm = torch.where(norm != 0, g_nrm / norm, zero)
            g_m = [g_m[k] + g_dn[k] / nrm + g_norm * d[k] for k in range(3)]
        if conf is not None:
            g_sh = g_sh * conf[:, None, None]

    if conf is not None:
        g_m = [v * conf for v in g_m]
        g_s = [v * conf for v in g_s]
        g_q = [v * conf for v in g_q]
        g_op = g_op * conf
    g_scaling = torch.stack(g_s, 1) * s_exp
    return ProjectionGrads(
        xyz=torch.stack(g_m, 1), scaling=g_scaling,
        opacity=None if override else (g_op * (1.0 - sig) * sig)[:, None],
        rotation=torch.stack(g_q, 1),
        features_dc=None if g_sh is None else g_sh[:, :1],
        features_rest=None if g_sh is None else g_sh[:, 1:],
        colors_precomp=g_precomp,
        opacity_override=g_op if override else None)
