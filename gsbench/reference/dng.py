"""Plain reference of a DNGaussian iteration (Li et al., CVPR 2024,
arXiv:2403.06912): the neural field, the depth-normalisation losses, the
penalties and the three passes, each with its own forward, backward and
Adam step.

Plain PyTorch, float32, TF32 off (`train.precision`), no kernel. It imports
nothing of the program: its own copies of the hash-grid encode (16 levels
of 2 features, trilinear over 8 corners, dense indexing where (r + 1)³
fits the table, else the uint32 xor-prime hash; positions clamped to the
bound), the two MLPs (sigma 32 → 64 → 64 → 1 + 64, colour SH-4 + 64 → 64 →
3 with the activation sigmoid·(1 + 2ε) − ε), the opacity product
sigmoid(sigma)·sigmoid(the point's opacity), the local and global
patch-normalised margin MSE, the edge-aware smoothness, and the shape,
scale and opacity penalties. The render is `render.py`'s projection (here
with the colour and the opacity put in place), binning and `_Rasterize`,
whose third image is the expected depth; L1, SSIM, Adam and the
learning rates are `train.py`'s.

The passes of one iteration over one view:
  1. hard: unit colours at opacity 0.95, scaling and rotation detached:
     only the means learn; the depth losses;
  2. soft (after `soft_depth_start`): the geometry detached; the opacity
     learns, through the field; the depth losses;
  3. photometric: L1 + λ·(1 − SSIM) + the penalties, the field evaluated
     twice (for the render and for the opacity penalty).
The Gaussians' Adam steps once a pass, a detached group with a zero
gradient; the field's Adam steps in the soft and photometric passes.

Departures from the paper, which the program shares (its PARITY.md,
"Known deviations"): one patch size an iteration, drawn from 5–16, serves
the four patch-norm losses (the paper draws each); the field's learning
rates are the constants 5e-3 (the table) and 5e-4 (the MLPs), not the
published schedules; the smoothness term's weight is 0.1 and it is on
after iteration 3000 whatever `lambda_smooth` says.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import render as rr
from .train import adam, l1, learning_rates, precision, ssim

HARD_OPACITY = 0.95
MIN_PATCH = 5
SMOOTH_FROM_ITER, SMOOTH_WEIGHT = 3000, 0.1
GRID_LR, NET_LR = 5e-3, 5e-4
COLOR_EPS = 1e-3
PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


# ------------------------------------------------------------ the field
def resolutions(f: dict) -> list:
    """Each level's grid resolution, base · b^l floored (float64)."""
    L = f["num_levels"]
    if L == 1:
        return [f["base_resolution"]]
    b = np.exp(np.log(f["desired_resolution"] / f["base_resolution"])
               / (L - 1))
    return [int(np.floor(f["base_resolution"] * b ** lv)) for lv in range(L)]


def encode(table, x, f: dict, bound: float):
    """The hash-grid features (N, L·F) of points x (N, 3) in [-bound,
    bound]; `table` (L, T, F)."""
    T = table.shape[1]
    u = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)
    out = []
    for lv, r in enumerate(resolutions(f)):
        pos = u * float(r)
        pos0 = torch.clamp(torch.clamp(torch.floor(pos).to(torch.int64),
                                       min=0), max=r - 1)
        frac = pos - pos0.to(torch.float32)
        feat = None
        for cx in (0, 1):
            wx = (1 - frac[:, 0]) if cx == 0 else frac[:, 0]
            for cy in (0, 1):
                wy = (1 - frac[:, 1]) if cy == 0 else frac[:, 1]
                for cz in (0, 1):
                    wz = (1 - frac[:, 2]) if cz == 0 else frac[:, 2]
                    ix, iy, iz = (pos0[:, 0] + cx, pos0[:, 1] + cy,
                                  pos0[:, 2] + cz)
                    if (r + 1) ** 3 <= T:
                        idx = (ix * (r + 1) + iy) * (r + 1) + iz
                    else:
                        idx = (((ix * PRIMES[0]) & U32)
                               ^ ((iy * PRIMES[1]) & U32)
                               ^ ((iz * PRIMES[2]) & U32)) & (T - 1)
                    term = (wx * wy * wz)[:, None] * table[lv][idx]
                    feat = term if feat is None else feat + term
        out.append(feat)
    return torch.cat(out, 1)


def mlp(w: dict, name: str, n_layers: int, x):
    for i in range(n_layers):
        x = x @ w[f"{name}.{i}.w"] + w[f"{name}.{i}.b"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def sh4(d):
    """The real SH basis of degree < 4 (16 values) of unit directions."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], -1)


def field_outputs(w: dict, f: dict, bound: float, xyz, opacity, cam_center):
    """(colour (N, 3), opacity (N,)) of the Gaussians at `xyz` seen from
    `cam_center`: the field at each mean along the unit view direction."""
    dirs = xyz - cam_center[None, :]
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
    h = mlp(w, "sigma_net", f["num_layers_sigma"],
            encode(w["encoder"], xyz - w["coord_center"], f, bound))
    sigma, geo = h[:, 0], h[:, 1:]
    c = mlp(w, "color_net", f["num_layers_color"],
            torch.cat([sh4(dirs), geo], -1))
    color = torch.sigmoid(c) * (1 + 2 * COLOR_EPS) - COLOR_EPS
    return color, torch.sigmoid(sigma) * torch.sigmoid(opacity[:, 0])


# ------------------------------------------------------- the depth losses
def patchify(x, ps: int):
    H, W = x.shape
    ny, nx = H // ps, W // ps
    x = x[:ny * ps, :nx * ps].reshape(ny, ps, nx, ps)
    return x.permute(0, 2, 1, 3).reshape(ny * nx, ps * ps)


def _std(var):
    return torch.sqrt(var + 1e-12)


def normalize(p, std=None):
    """Each patch less its mean over (its unbiased std, or `std`) + 1e-2 ×
    the unbiased std of all the patches."""
    n = p.shape[1]
    mean = p.mean(dim=1, keepdim=True)
    if std is None:
        std = _std(((p - mean) ** 2).sum(dim=1, keepdim=True) / (n - 1))
    g = _std(((p - p.mean()) ** 2).sum() / (p.numel() - 1))
    return (p - mean) / (std + 1e-2 * g)


def margin_mse(x, y, margin: float):
    d = x - y
    mask = (torch.abs(d) > margin).to(x.dtype)
    return (d * d * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def local_loss(pred, gt, ps: int, margin: float):
    return margin_mse(normalize(patchify(pred, ps)),
                      normalize(patchify(gt, ps)), margin)


def global_loss(pred, gt, ps: int, margin: float):
    ps_std = _std(pred.reshape(-1).var(correction=1)).detach()
    gt_std = _std(gt.reshape(-1).var(correction=1)).detach()
    return margin_mse(normalize(patchify(pred, ps), ps_std),
                      normalize(patchify(gt, ps), gt_std), margin)


def smoothness(depth, img):
    """Edge-aware smoothness of depth (H, W) under img (H, W, C)."""
    depth = depth[..., None]
    wx = torch.exp(-torch.abs(img[:, :-1] - img[:, 1:]).mean(-1,
                                                             keepdim=True))
    wy = torch.exp(-torch.abs(img[:-1] - img[1:]).mean(-1, keepdim=True))
    dx = torch.abs(depth[:, :-1] - depth[:, 1:])
    dy = torch.abs(depth[:-1] - depth[1:])
    return ((dx * wx).sum() + (dy * wy).sum()) / (wx.sum() + wy.sum())


def depth_losses(depth, mono, img, patch: int, margin: float,
                 smooth: bool):
    loss = (0.1 * local_loss(depth, mono, patch, margin)
            + global_loss(depth, mono, patch, margin))
    if smooth:
        loss = loss + SMOOTH_WEIGHT * smoothness(depth, img)
    return loss


def penalties(params: dict, opac, opt: dict):
    """The shape, scale and opacity penalties, weighted."""
    n = float(params["xyz"].shape[0])
    s = torch.exp(params["scaling"])
    smax, smin = s.max(dim=-1).values, s.min(dim=-1).values
    shape = torch.sum(smax / torch.clamp(smin, min=1e-12)) / n
    scale = torch.sum(smax ** 2) / n
    hi = (opac > 0.2).to(torch.float32)
    lo = (opac < 0.2).to(torch.float32)
    opa = (1.0 - torch.sum(opac ** 2 * hi) / torch.clamp(hi.sum(), min=1.0)
           + torch.sum((1 - opac) ** 2 * lo) / torch.clamp(lo.sum(), min=1.0))
    return (opt["shape_pena"] * shape + opt["scale_pena"] * scale
            + opt["opa_pena"] * opa)


# ------------------------------------------------------------ the render
def project(params: dict, view, width: int, height: int, colors,
            opacities) -> rr.Projected:
    """`render.project` with the colours (P, 3) and the activated
    opacities (P,) put in place of the SH colour and sigmoid(opacity)."""
    xyz = params["xyz"]
    f32 = dict(dtype=torch.float32, device=xyz.device)
    viewmat = torch.as_tensor(view.viewmat, **f32)
    full_proj = torch.as_tensor(view.full_proj, **f32)
    tan_fovx, tan_fovy = float(view.tan_fovx), float(view.tan_fovy)
    P = xyz.shape[0]
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    homog = torch.cat([xyz, xyz.new_ones((P, 1))], dim=1)
    p_view = homog @ viewmat.T
    p_hom = homog @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    in_front = p_view[:, 2] > rr.NEAR_CULL_Z
    safe_z = torch.where(in_front, p_view[:, 2], torch.ones_like(p_w))
    p_view_safe = torch.stack([p_view[:, 0], p_view[:, 1], safe_z], dim=1)
    cov3d = rr._cov3d(torch.exp(params["scaling"]), params["rotation"])
    cxx, cxy, cyy = rr._cov2d(p_view_safe, cov3d, viewmat, focal_x, focal_y,
                              tan_fovx, tan_fovy)
    cxx_d, cyy_d = cxx + rr.DILATION, cyy + rr.DILATION
    det_dil = cxx_d * cyy_d - cxy * cxy
    valid = in_front & (det_dil != 0.0)
    det_inv = 1.0 / torch.where(det_dil == 0, torch.ones_like(det_dil),
                                det_dil)
    conics = torch.stack([cyy_d * det_inv, -cxy * det_inv, cxx_d * det_inv],
                         -1)
    mid = 0.5 * (cxx_d + cyy_d)
    disc = torch.sqrt(torch.clamp(mid * mid - det_dil, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                       mid - disc)))
    means2d = torch.stack([((p_proj[:, 0] + 1.0) * width - 1.0) * 0.5,
                           ((p_proj[:, 1] + 1.0) * height - 1.0) * 0.5], -1)
    min_x, max_x, min_y, max_y = rr.rects(means2d, radius, width, height,
                                          rr.CULL_TILE, rr.CULL_TILE)
    valid = valid & ((max_x - min_x) * (max_y - min_y) > 0)
    zero = torch.zeros_like(radius)
    radii = torch.where(valid & torch.isfinite(radius),
                        torch.clamp(radius, max=1e7), zero).to(torch.int32)
    op_final = torch.where(valid, opacities, zero)
    two_l = 2.0 * torch.log(torch.clamp(op_final, min=1e-12) * 255.0)
    rx = torch.ceil(torch.sqrt(torch.clamp(two_l * cxx_d, min=0.0))) + 1.0
    ry = torch.ceil(torch.sqrt(torch.clamp(two_l * cyy_d, min=0.0))) + 1.0
    rect = torch.stack([torch.minimum(radius, rx), torch.minimum(radius, ry)],
                       -1)
    keep = (valid & (op_final >= 1.0 / 255.0) & torch.isfinite(radius)
            & torch.isfinite(rect[:, 0]) & torch.isfinite(rect[:, 1]))
    rect_radii = torch.where(keep[:, None], torch.clamp(rect, max=1e7),
                             torch.zeros_like(rect)).to(torch.int32)
    return rr.Projected(
        means2d=means2d,
        depths=torch.where(valid, p_view[:, 2],
                           torch.full_like(p_w, float("inf"))),
        radii=radii, conics=conics, colors=colors, opacities=op_final,
        rect_radii=rect_radii)


def render(params: dict, view, width: int, height: int, bg, colors,
           opacities, tile: int = 16):
    """The differentiable training render with colours and opacities put
    in place: (image clamped to [0, 1], expected depth (H, W), the
    forward's `Work`, pairs)."""
    pr = project(params, view, width, height, colors, opacities)
    bins = rr.bin_pairs(pr.means2d.detach(), pr.depths.detach(),
                        pr.rect_radii, width, height, tile, tile)
    works = []
    color, _, depth, _ = rr._Rasterize.apply(
        pr.means2d.contiguous(), pr.depths.contiguous(),
        pr.conics.contiguous(), pr.colors.contiguous(),
        pr.opacities.contiguous(), bins, bg, (width, height, tile, tile),
        works)
    return torch.clamp(color, 0.0, 1.0), depth, works[0], bins.n_pairs


# ------------------------------------------------------------ the passes
def _leaves(params: dict, frozen=()) -> dict:
    return {k: (p.detach() if k in frozen else
                p.detach().requires_grad_(True)) for k, p in params.items()}


def _grads(leaves: dict) -> dict:
    return {k: (t.grad if t.requires_grad and t.grad is not None
                else torch.zeros_like(t)) for k, t in leaves.items()}


def steps(params: dict, field: dict, m: dict, v: dict, fm: dict, fv: dict,
          adam_step: int, field_step: int, start_it: int, views: list,
          targets: list, monos: list, patch_idxs: list, cfg: dict,
          extent: float, tf32: bool = False) -> dict:
    """The reference's iterations from a state: one view each (`views[i]`
    against `targets[i]` and the mono-depth map `monos[i]` = 255 − prior,
    at the patch size MIN_PATCH + `patch_idxs[i]`), in place on `params`,
    `field` and the two Adams' moments. Returns each iteration's pass
    losses, and each leaf's first-moment norm ÷ (1 − β1) after the first
    iteration (the fixed combination of the passes' gradients that the
    program's Adam holds then), field leaves under `field.<name>`."""
    opt, f = cfg["opt"], cfg["field"]
    W, H = cfg["width"], cfg["height"]
    dev = params["xyz"].device
    bg = torch.zeros(3, device=dev)
    bound = max(extent, 1.0)
    flrs = {k: (GRID_LR if k == "encoder" else
                0.0 if k == "coord_center" else NET_LR) for k in field}
    margin = opt["error_tolerance"]
    out = {"loss": [], "grad_norm": None}
    a_step, f_step = adam_step, field_step

    def gauss_adam(leaves, lrs):
        nonlocal a_step
        a_step += 1
        adam(params, _grads(leaves), m, v, a_step, lrs)

    def field_adam(fleaves):
        nonlocal f_step
        f_step += 1
        adam(field, _grads(fleaves), fm, fv, f_step, flrs)

    with precision(tf32):
        for i, (view, gt, mono) in enumerate(zip(views, targets, monos)):
            it = start_it + i + 1
            ps = MIN_PATCH + patch_idxs[i]
            smooth = it > SMOOTH_FROM_ITER
            lrs = learning_rates(opt, extent, it)
            cam_center = torch.as_tensor(view.cam_center,
                                         dtype=torch.float32, device=dev)
            P = params["xyz"].shape[0]
            losses = []

            # 1. hard: only the means learn
            lv = _leaves(params, ("scaling", "rotation", "features_dc",
                                  "features_rest", "opacity"))
            _, depth, _, _ = render(lv, view, W, H, bg,
                                    torch.ones((P, 3), device=dev),
                                    torch.full((P,), HARD_OPACITY,
                                               device=dev))
            loss = depth_losses(depth, mono, gt, ps, margin, smooth)
            loss.backward()
            gauss_adam(lv, lrs)
            losses.append(float(loss.detach()))

            # 2. soft: the opacity and the field learn
            if it > opt["soft_depth_start"]:
                lv = _leaves(params, ("xyz", "scaling", "rotation",
                                      "features_dc", "features_rest"))
                fl = _leaves(field)
                color, opac = field_outputs(fl, f, bound, lv["xyz"],
                                            lv["opacity"], cam_center)
                _, depth, _, _ = render(lv, view, W, H, bg, color, opac)
                loss = depth_losses(depth, mono, gt, ps, margin, smooth)
                loss.backward()
                gauss_adam(lv, lrs)
                field_adam(fl)
                losses.append(float(loss.detach()))

            # 3. photometric: every group but the SH, which the field's
            # colour replaces
            lv = _leaves(params, ("features_dc", "features_rest"))
            fl = _leaves(field)
            color, opac = field_outputs(fl, f, bound, lv["xyz"],
                                        lv["opacity"], cam_center)
            image, _, _, _ = render(lv, view, W, H, bg, color, opac)
            _, opac2 = field_outputs(fl, f, bound, lv["xyz"], lv["opacity"],
                                     cam_center)
            loss = (l1(image, gt) + opt["lambda_dssim"]
                    * (1.0 - ssim(image, gt)) + penalties(lv, opac2, opt))
            loss.backward()
            gauss_adam(lv, lrs)
            field_adam(fl)
            losses.append(float(loss.detach()))

            out["loss"].append(losses)
            if out["grad_norm"] is None:
                out["grad_norm"] = {
                    **{k: float(torch.linalg.vector_norm(m[k] / 0.1))
                       for k in params},
                    **{"field." + k: float(torch.linalg.vector_norm(
                        fm[k] / 0.1)) for k in field}}
            del lv, fl, loss, image, depth
    return out


@torch.no_grad()
def count_work(params: dict, field: dict, cfg: dict, extent: float, view,
               kind: str):
    """(`Work`, pairs, tiles) of one pass's render of `view`, replayed:
    `hard` at unit colours and opacity 0.95, `neural` with the field's."""
    W, H = cfg["width"], cfg["height"]
    dev = params["xyz"].device
    P = params["xyz"].shape[0]
    if kind == "hard":
        colors = torch.ones((P, 3), device=dev)
        opac = torch.full((P,), HARD_OPACITY, device=dev)
    else:
        colors, opac = field_outputs(
            field, cfg["field"], max(extent, 1.0), params["xyz"],
            params["opacity"], torch.as_tensor(view.cam_center,
                                               dtype=torch.float32,
                                               device=dev))
    pr = project(params, view, W, H, colors, opac)
    bins = rr.bin_pairs(pr.means2d, pr.depths, pr.rect_radii, W, H, 16, 16)
    out = rr.forward(pr, bins, torch.zeros(3, device=dev), W, H, 16, 16)
    gx, gy = rr.tile_grid(W, H, 16, 16)
    return out.work, bins.n_pairs, gx * gy


def field_values(f: dict, seed_gen: torch.Generator) -> dict:
    """The field's parameters by name, drawn from `seed_gen`: the table
    uniform in ± `table_scale`, each MLP layer's weights and biases
    uniform in ± 1/√fan-in, `coord_center` 0."""
    dev = seed_gen.device
    L, T = f["num_levels"], 1 << f["log2_hashmap_size"]
    s = f["table_scale"]
    out = {"encoder": (2 * torch.rand((L, T, f["level_dim"]),
                                      generator=seed_gen, device=dev) - 1)
           * s}
    sigma = ([L * f["level_dim"]] + [f["hidden_dim"]]
             * (f["num_layers_sigma"] - 1) + [1 + f["geo_feat_dim"]])
    color = ([f["sh_degree"] ** 2 + f["geo_feat_dim"]]
             + [f["hidden_dim_color"]] * (f["num_layers_color"] - 1) + [3])
    for name, dims in (("sigma_net", sigma), ("color_net", color)):
        for i in range(len(dims) - 1):
            lim = 1.0 / math.sqrt(dims[i])
            for key, shape in (("w", (dims[i], dims[i + 1])),
                               ("b", (dims[i + 1],))):
                out[f"{name}.{i}.{key}"] = (2 * torch.rand(
                    shape, generator=seed_gen, device=dev) - 1) * lim
    out["coord_center"] = torch.zeros(3, device=dev)
    return out
