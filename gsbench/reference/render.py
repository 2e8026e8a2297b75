"""Plain reference renderer: projection, tile binning and the tile
rasterizer's forward and backward in plain PyTorch.

A frozen copy of the port's plain versions in the same operation order
(`ops/projection.py`, `utils/sh.py`, `ops/binning.py`, `ops/blending.py`,
`ops/raster.py::rasterize_forward_torch`, `rasterize_backward_torch`,
`RasterizeFunction`), so the two agree to f32 rounding on the same
inputs. Only the paths a cell runs are kept: no antialiasing, no
precomputed colours, no bands. The forward also returns what the
rooflines count (`Work`): each pixel's contributing (pair, pixel)
evaluations and whether the pixel stops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEAR_CULL_Z = 0.2
DILATION = 0.3
CULL_TILE = 16

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_EPS = math.log(1e-4)

CHUNK = 256
MAX_ELEMS = 1 << 22

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(deg: int, sh, dirs):
    """Real SH of degrees ≤ 3: sh (P, K, C), dirs (P, 3) → (P, C)."""
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1, :]
                  + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4, :]
                      + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :]
                      + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (result
                          + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                          + SH_C3[1] * xy * z * sh[..., 10, :]
                          + SH_C3[2] * y * (4.0 * zz - xx - yy)
                          * sh[..., 11, :]
                          + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                          * sh[..., 12, :]
                          + SH_C3[4] * x * (4.0 * zz - xx - yy)
                          * sh[..., 13, :]
                          + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


class Projected(NamedTuple):
    means2d: torch.Tensor     # (P, 2) pixels
    depths: torch.Tensor      # (P,) camera z; inf where culled
    radii: torch.Tensor       # (P,) int32, 0 = culled
    conics: torch.Tensor      # (P, 3)
    colors: torch.Tensor      # (P, 3)
    opacities: torch.Tensor   # (P,)
    rect_radii: torch.Tensor  # (P, 2) int32 binning half-sides


def _cov3d(scales, quats):
    q = quats / torch.clamp(
        torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-24),
        min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    s2 = (1.0 * scales) ** 2

    def sig(i, k):
        return (R[i][0] * R[k][0] * s2[..., 0] + R[i][1] * R[k][1] * s2[..., 1]
                + R[i][2] * R[k][2] * s2[..., 2])

    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1),
                        sig(1, 2), sig(2, 2)], -1)


def _cov2d(p_view, cov3d, viewmat, focal_x, focal_y, tan_fovx, tan_fovy):
    tz = p_view[:, 2]
    tx = torch.clamp(p_view[:, 0] / tz, -1.3 * tan_fovx, 1.3 * tan_fovx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -1.3 * tan_fovy, 1.3 * tan_fovy) * tz
    inv_z = 1.0 / tz
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


def tile_grid(width: int, height: int, tile_x: int, tile_y: int):
    return (width + tile_x - 1) // tile_x, (height + tile_y - 1) // tile_y


def _trunc_clip(v, hi: int):
    return torch.clamp(torch.clamp(v, -1.0, float(hi)).to(torch.int32), 0, hi)


def _split(radii):
    if radii.ndim == 2:
        return (radii[:, 0].to(torch.float32), radii[:, 1].to(torch.float32),
                torch.amin(radii, dim=1) > 0)
    r = radii.to(torch.float32)
    return r, r, radii > 0


def rects(means2d, radii, width, height, tile_x, tile_y):
    """Clamped tile rect [min, max) per Gaussian (3DGS `getRect`)."""
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    rx, ry, _ = _split(radii)
    return (_trunc_clip((means2d[:, 0] - rx) / tile_x, gx),
            _trunc_clip((means2d[:, 0] + rx + tile_x - 1) / tile_x, gx),
            _trunc_clip((means2d[:, 1] - ry) / tile_y, gy),
            _trunc_clip((means2d[:, 1] + ry + tile_y - 1) / tile_y, gy))


def project(params: dict, view, width: int, height: int,
            sh_degree: int) -> Projected:
    """The projection of every Gaussian (pre-activation `params`) into
    `view` (`scene.View`), with SH colours of degree `sh_degree`."""
    xyz = params["xyz"]
    dev = xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    viewmat = torch.as_tensor(view.viewmat, **f32)
    full_proj = torch.as_tensor(view.full_proj, **f32)
    cam_center = torch.as_tensor(view.cam_center, **f32)
    scales = torch.exp(params["scaling"])
    opacities = torch.sigmoid(params["opacity"][:, 0])
    quats = params["rotation"]
    sh = torch.cat([params["features_dc"], params["features_rest"]], 1)
    tan_fovx, tan_fovy = float(view.tan_fovx), float(view.tan_fovy)
    P = xyz.shape[0]
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    homog = torch.cat([xyz, xyz.new_ones((P, 1))], dim=1)
    p_view = homog @ viewmat.T
    p_hom = homog @ full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    in_front = p_view[:, 2] > NEAR_CULL_Z
    safe_z = torch.where(in_front, p_view[:, 2], torch.ones_like(p_w))
    p_view_safe = torch.stack([p_view[:, 0], p_view[:, 1], safe_z], dim=1)
    cov3d = _cov3d(scales, quats)
    cxx, cxy, cyy = _cov2d(p_view_safe, cov3d, viewmat, focal_x, focal_y,
                           tan_fovx, tan_fovy)
    cxx_d = cxx + DILATION
    cyy_d = cyy + DILATION
    det_dil = cxx_d * cyy_d - cxy * cxy
    h_scale = torch.ones_like(det_dil)
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
    min_x, max_x, min_y, max_y = rects(means2d, radius, width, height,
                                       CULL_TILE, CULL_TILE)
    valid = valid & ((max_x - min_x) * (max_y - min_y) > 0)

    dirs = xyz - cam_center[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    colors = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)

    zero = torch.zeros_like(radius)
    radii = torch.where(valid & torch.isfinite(radius),
                        torch.clamp(radius, max=1e7), zero).to(torch.int32)
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
        radii=radii, conics=conics, colors=colors, opacities=op_final,
        rect_radii=rect_radii)


class Bins(NamedTuple):
    ids: torch.Tensor      # (n_pairs,) int64 Gaussian ids by (tile, depth)
    starts: torch.Tensor   # (tiles,) int64
    counts: torch.Tensor   # (tiles,) int64
    n_pairs: int


def bin_pairs(means2d, depths, rect_radii, width, height, tile_x,
              tile_y) -> Bins:
    """(tile, Gaussian) pairs sorted by (tile, top depth bits), stably, in
    the expansion order Gaussian by Gaussian and row-major over its rect."""
    dev = means2d.device
    P = means2d.shape[0]
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    depth_bits = min(32 - max(1, (gx * gy).bit_length()), 22)
    min_x, max_x, min_y, max_y = rects(means2d, rect_radii, width, height,
                                       tile_x, tile_y)
    _, _, live = _split(rect_radii)
    rect_w = max_x - min_x
    touched = torch.where(live, rect_w * (max_y - min_y),
                          torch.zeros_like(rect_w)).to(torch.int64)
    total = int(touched.sum())
    gid = torch.repeat_interleave(torch.arange(P, device=dev), touched,
                                  output_size=total)
    offsets = torch.cumsum(touched, 0) - touched
    j = torch.arange(total, device=dev) - offsets[gid]
    rw = rect_w.to(torch.int64)[gid]
    jq = torch.div(j, rw, rounding_mode="floor")
    tile_id = ((min_y.to(torch.int64)[gid] + jq) * gx
               + min_x.to(torch.int64)[gid] + (j - jq * rw))
    d = torch.where(torch.isfinite(depths), depths, torch.zeros_like(depths))
    dkey = (d.contiguous().view(torch.int32).to(torch.int64)
            & 0xFFFFFFFF) >> (32 - depth_bits)
    key = (tile_id << depth_bits) | dkey[gid]
    _, order = torch.sort(key, stable=True)
    counts = torch.bincount(tile_id, minlength=gx * gy)
    return Bins(gid[order], torch.cumsum(counts, 0) - counts, counts, total)


def _alpha(power, opacity):
    alpha = torch.clamp(opacity * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    return torch.where((power > 0.0) | (alpha < ALPHA_EPS),
                       torch.zeros_like(alpha), alpha)


def _untile(tiles, width, height, tile_x, tile_y):
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    k = tiles.shape[-1]
    img = tiles.reshape(gy, gx, tile_y, tile_x, k)
    return img.permute(0, 2, 1, 3, 4).reshape(gy * tile_y, gx * tile_x,
                                              k)[:height, :width]


def _tile(img, width, height, tile_x, tile_y):
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    k = img.shape[-1]
    img = torch.nn.functional.pad(
        img, (0, 0, 0, gx * tile_x - width, 0, gy * tile_y - height))
    img = img.reshape(gy, tile_y, gx, tile_x, k)
    return img.permute(0, 2, 1, 3, 4).reshape(gy * gx, tile_x * tile_y, k)


class Work(NamedTuple):
    """What a forward's inputs ask of the rasterizer: contributing (pair,
    pixel) evaluations (before the pixel's stop, not skipped) and pixels
    that stop before their tile's last pair."""
    contrib: int
    stops: int


class Raster(NamedTuple):
    color: torch.Tensor      # (H, W, C)
    invdepth: torch.Tensor   # (H, W)
    depth: torch.Tensor      # (H, W)
    alpha: torch.Tensor      # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32: pairs before the stop
    log_t: torch.Tensor      # (H, W)
    work: Work


def forward(pr: Projected, bins: Bins, bg, width, height, tile_x,
            tile_y) -> Raster:
    """Blend every tile's sorted pairs front to back (the port's plain
    forward): tiles in batches of similar depth, pairs in CHUNK pieces
    carrying (log T, done) per pixel."""
    means2d, depths, conics = pr.means2d, pr.depths, pr.conics
    colors, opacities, ids = pr.colors, pr.opacities, bins.ids
    C = colors.shape[-1]
    dev = means2d.device
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    num_tiles, pix = gx * gy, tile_x * tile_y
    safe = torch.where(torch.isfinite(depths), depths,
                       torch.ones_like(depths))
    payload = torch.cat([colors, (1.0 / safe)[:, None], safe[:, None]], 1)
    lin = torch.arange(pix, device=dev)
    lx = (lin % tile_x).to(torch.float32)
    ly = (lin // tile_x).to(torch.float32)
    acc = torch.zeros((num_tiles, pix, C + 2), device=dev)
    log_t = torch.zeros((num_tiles, pix), device=dev)
    n_con = torch.zeros((num_tiles, pix), dtype=torch.int32, device=dev)
    contrib_sum = torch.zeros((), dtype=torch.int64, device=dev)
    stops = torch.zeros((), dtype=torch.int64, device=dev)
    order = torch.argsort(bins.counts, descending=True, stable=True)
    counts_sorted = bins.counts[order].tolist()
    tb = max(1, MAX_ELEMS // (pix * CHUNK))
    for b0 in range(0, num_tiles, tb):
        kmax = counts_sorted[b0]
        if kmax == 0:
            break
        tsel = order[b0:b0 + tb]
        B = tsel.shape[0]
        px = ((tsel % gx) * tile_x).to(torch.float32)[:, None] + lx
        py = ((tsel // gx) * tile_y).to(torch.float32)[:, None] + ly
        cnt = bins.counts[tsel]
        inside = (px < width) & (py < height)
        lt = torch.zeros((B, pix), device=dev)
        done = torch.zeros((B, pix), dtype=torch.bool, device=dev)
        acc_b = torch.zeros((B, pix, C + 2), device=dev)
        nc = torch.zeros((B, pix), dtype=torch.int32, device=dev)
        for k0 in range(0, kmax, CHUNK):
            k = torch.arange(k0, k0 + CHUNK, device=dev)
            valid = k[None, :] < cnt[:, None]
            slot = torch.clamp(bins.starts[tsel][:, None] + k[None, :],
                               max=ids.shape[0] - 1)
            g = ids[slot]
            m = means2d[g]
            con = conics[g]
            dx = px[:, :, None] - m[:, None, :, 0]
            dy = py[:, :, None] - m[:, None, :, 1]
            a, b, c = (con[:, None, :, i] for i in range(3))
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = _alpha(power, opacities[g][:, None, :])
            alpha = torch.where(valid[:, None, :], alpha,
                                torch.zeros_like(alpha))
            log1m = torch.log1p(-alpha)
            s_incl = lt[..., None] + torch.cumsum(log1m, dim=-1)
            s_excl = s_incl - log1m
            crossed = s_incl < LOG_T_EPS
            d = (torch.cumsum(crossed.to(torch.int32), dim=-1) > 0) \
                | done[..., None]
            contribute = ~d
            w = alpha * torch.exp(s_excl) * contribute
            acc_b += torch.einsum("bpk,bkc->bpc", w, payload[g])
            lt = lt + torch.sum(torch.where(contribute, log1m,
                                            torch.zeros_like(log1m)), dim=-1)
            done = d[..., -1]
            live = contribute & valid[:, None, :]
            nc += live.sum(-1, dtype=torch.int32)
            contrib_sum += (live & (alpha > 0) & inside[..., None]).sum()
        stops += (done & inside).sum()
        acc[tsel] = acc_b
        log_t[tsel] = lt
        n_con[tsel] = nc
    t_final = torch.exp(log_t)
    color = acc[..., :C] + t_final[..., None] * bg
    tiles = torch.cat([color, acc[..., C:], (1.0 - t_final)[..., None],
                       n_con[..., None].to(torch.float32),
                       log_t[..., None]], dim=-1)
    img = _untile(tiles, width, height, tile_x, tile_y)
    return Raster(img[..., :C].contiguous(), img[..., C].contiguous(),
                  img[..., C + 1].contiguous(), img[..., C + 2].contiguous(),
                  img[..., C + 3].to(torch.int32), img[..., C + 4].contiguous(),
                  Work(int(contrib_sum), int(stops)))


def backward(pr: Projected, bins: Bins, bg, log_t, n_contrib, g_color,
             g_invdepth, g_depth, g_alpha, width, height, tile_x,
             tile_y) -> torch.Tensor:
    """Per-pair gradients (n_pairs, C + 8), columns [mx, my, a, b, c,
    opacity, colours, invdepth, depth] (the port's plain backward)."""
    means2d, depths, conics = pr.means2d, pr.depths, pr.conics
    colors, opacities, ids = pr.colors, pr.opacities, bins.ids
    C = colors.shape[-1]
    dev = means2d.device
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    num_tiles, pix = gx * gy, tile_x * tile_y
    safe = torch.where(torch.isfinite(depths), depths,
                       torch.ones_like(depths))
    payload = torch.cat([colors, (1.0 / safe)[:, None], safe[:, None]], 1)
    img = torch.cat([g_color, g_invdepth[..., None], g_depth[..., None],
                     g_alpha[..., None], log_t[..., None],
                     n_contrib[..., None].to(torch.float32)], -1)
    tiles = _tile(img, width, height, tile_x, tile_y)
    g_t = tiles[..., :C + 2]
    back = torch.exp(tiles[..., C + 3]) * (
        (g_t[..., :C] * bg).sum(-1) - tiles[..., C + 2])
    log_tf = tiles[..., C + 3]
    nc = tiles[..., C + 4]
    lin = torch.arange(pix, device=dev)
    lx = (lin % tile_x).to(torch.float32)
    ly = (lin // tile_x).to(torch.float32)
    out = torch.zeros((ids.shape[0], C + 8), device=dev)
    order = torch.argsort(bins.counts, descending=True, stable=True)
    counts_sorted = bins.counts[order].tolist()
    tb = max(1, MAX_ELEMS // (pix * CHUNK))
    for b0 in range(0, num_tiles, tb):
        kmax = counts_sorted[b0]
        if kmax == 0:
            break
        tsel = order[b0:b0 + tb]
        B = tsel.shape[0]
        px = ((tsel % gx) * tile_x).to(torch.float32)[:, None] + lx
        py = ((tsel // gx) * tile_y).to(torch.float32)[:, None] + ly
        cnt = bins.counts[tsel]
        gb, back_b, ltf_b, nc_b = g_t[tsel], back[tsel], log_tf[tsel], nc[tsel]
        c_log = torch.zeros((B, pix), device=dev)
        s_carry = torch.zeros((B, pix), device=dev)
        for k0 in reversed(range(0, kmax, CHUNK)):
            k = torch.arange(k0, min(k0 + CHUNK, kmax), device=dev)
            valid = k[None, :] < cnt[:, None]
            slot = torch.clamp(bins.starts[tsel][:, None] + k[None, :],
                               max=max(ids.shape[0] - 1, 0))
            g = ids[slot]
            m = means2d[g]
            con = conics[g]
            dx = px[:, :, None] - m[:, None, :, 0]
            dy = py[:, :, None] - m[:, None, :, 1]
            a, b, c = (con[:, None, :, i] for i in range(3))
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            G = torch.exp(torch.clamp(power, max=0.0))
            alpha_raw = opacities[g][:, None, :] * G
            alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
            contrib = (valid[:, None, :]
                       & (k.to(torch.float32)[None, None, :] < nc_b[..., None])
                       & ~((power > 0.0) | (alpha < ALPHA_EPS)))
            alpha = torch.where(contrib, alpha, torch.zeros_like(alpha))
            log1m = torch.log1p(-alpha)
            r_incl = torch.flip(torch.cumsum(torch.flip(log1m, [-1]), -1),
                                [-1])
            T = torch.exp(ltf_b[..., None] - r_incl - c_log[..., None])
            w = alpha * T
            gc = torch.einsum("bpc,bkc->bpk", gb, payload[g])
            wgc = w * gc
            suffix = (torch.flip(torch.cumsum(torch.flip(wgc, [-1]), -1),
                                 [-1]) - wgc + s_carry[..., None])
            dalpha = torch.where(
                contrib, T * gc - (suffix + back_b[..., None])
                / torch.clamp(1.0 - alpha, min=1e-6), torch.zeros_like(alpha))
            live = contrib & (alpha_raw <= ALPHA_MAX)
            zero = torch.zeros_like(alpha)
            q = torch.where(live, dalpha * alpha, zero)
            rows = torch.stack([
                (q * (a * dx + b * dy)).sum(1),
                (q * (c * dy + b * dx)).sum(1),
                (-0.5 * q * dx * dx).sum(1),
                (-q * dx * dy).sum(1),
                (-0.5 * q * dy * dy).sum(1),
                torch.where(live, dalpha * G, zero).sum(1)], -1)
            d_pay = torch.einsum("bpk,bpc->bkc", w, gb)
            rows = torch.cat([rows, d_pay], -1)
            out[slot[valid]] = rows[valid]
            c_log = c_log + log1m.sum(-1)
            s_carry = s_carry + wgc.sum(-1)
    return out


class _Rasterize(torch.autograd.Function):
    """The differentiable training rasterizer: the plain forward, then the
    plain backward and the per-Gaussian sum of its pair rows."""

    @staticmethod
    def forward(ctx, means2d, depths, conics, colors, opacities, bins, bg,
                dims, works):
        pr = Projected(means2d, depths, None, conics, colors, opacities, None)
        out = forward(pr, bins, bg, *dims)
        ctx.save_for_backward(means2d, depths, conics, colors, opacities, bg,
                              out.log_t, out.n_contrib)
        ctx.bins, ctx.dims = bins, dims
        works.append(out.work)
        return out.color, out.invdepth, out.depth, out.alpha

    @staticmethod
    def backward(ctx, d_color, d_invd, d_depth, d_alpha):
        (means2d, depths, conics, colors, opacities, bg, log_t,
         n_contrib) = ctx.saved_tensors
        C = colors.shape[-1]
        cot = [t.contiguous().to(torch.float32)
               for t in (d_color, d_invd, d_depth, d_alpha)]
        pr = Projected(means2d, depths, None, conics, colors, opacities, None)
        pairs = backward(pr, ctx.bins, bg, log_t, n_contrib, *cot, *ctx.dims)
        per = torch.zeros((means2d.shape[0], C + 8), device=pairs.device)
        per.index_add_(0, ctx.bins.ids, pairs)
        finite = torch.isfinite(depths)
        safe = torch.where(finite, depths, torch.ones_like(depths))
        d_depths = torch.where(finite,
                               -per[:, 6 + C] / (safe * safe) + per[:, 7 + C],
                               torch.zeros_like(depths))
        d_bg = (torch.exp(log_t)[..., None] * cot[0]).sum((0, 1))
        return (per[:, 0:2], d_depths, per[:, 2:5], per[:, 6:6 + C],
                per[:, 5], None, d_bg, None, None)


def render_train(params: dict, view, width: int, height: int, bg,
                 sh_degree: int, tile: int = 16):
    """The differentiable training render at `tile`×`tile` tiles: (image
    clamped to [0, 1], the forward's `Work`)."""
    pr = project(params, view, width, height, sh_degree)
    bins = bin_pairs(pr.means2d.detach(), pr.depths.detach(), pr.rect_radii,
                     width, height, tile, tile)
    works = []
    color, _, _, _ = _Rasterize.apply(
        pr.means2d.contiguous(), pr.depths.contiguous(),
        pr.conics.contiguous(), pr.colors.contiguous(),
        pr.opacities.contiguous(), bins, bg, (width, height, tile, tile),
        works)
    return torch.clamp(color, 0.0, 1.0), works[0], bins.n_pairs


@torch.no_grad()
def render_frame(params: dict, view, width: int, height: int, bg,
                 sh_degree: int, tile_x: int = 32, tile_y: int = 16):
    """An inference frame: (image clamped to [0, 1], `Work`, pairs)."""
    pr = project(params, view, width, height, sh_degree)
    bins = bin_pairs(pr.means2d, pr.depths, pr.rect_radii, width, height,
                     tile_x, tile_y)
    out = forward(pr, bins, bg, width, height, tile_x, tile_y)
    return torch.clamp(out.color, 0.0, 1.0), out.work, bins.n_pairs


def count_work(params: dict, view, width: int, height: int, sh_degree: int,
               tile_x: int, tile_y: int):
    """(`Work`, pairs, tiles) of one view's forward, replayed."""
    _, work, n_pairs = render_frame(params, view, width, height,
                                    torch.zeros(3, device=params["xyz"].device),
                                    sh_degree, tile_x, tile_y)
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    return work, n_pairs, gx * gy
