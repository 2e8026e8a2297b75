"""Tile rasterizer, forward and backward: the hand-written CUDA kernels and
their plain PyTorch versions, joined by a `torch.autograd.Function`.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/pallas/raster.py`,
`ops/pallas/raster_bwd.py` and `ops/pallas/raster_vjp.py`. Each wrapper
dispatches on the device of its tensors: on CUDA tensors it launches its
kernel (or raises), on CPU tensors it runs its plain version. There is no
fallback from one to the other.
  rasterize_forward   csrc/raster_fwd.cu | rasterize_forward_torch
  rasterize_backward  csrc/raster_bwd.cu | rasterize_backward_torch
  pairs_to_gaussians  csrc/raster_bwd.cu | pairs_to_gaussians_torch
Each wrapper's `launches` counts its kernel launches.

Inputs are per-Gaussian arrays plus the binning of `ops/binning.py`:
  means2d (P, 2), depths (P,), conics (P, 3), colors (P, C), opacities (P,)
  float32; ids (n_pairs,), tile_starts/tile_counts (num_tiles,) int32;
  bg (C,) float32; for the per-Gaussian sum of the backward, the
  binning's gaussian_slots (n_pairs,) and gaussian_offsets (P + 1,) int32.
Forward outputs are images: color (H, W, C), invdepth, depth, alpha (H, W)
and, for the training instantiation, n_contrib (H, W) int32 — every pair
before the sticky stop, skipped pairs included — and log_t (H, W), the
log-domain T_final, which the backward replays.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..utils.tracing import span
from ._build import load
from .binning import tile_grid
from .blending import ALPHA_EPS, ALPHA_MAX, LOG_T_EPS, alpha_from_power

MAX_PAYLOAD = 8          # C colours + inverse depth + depth
MAX_TILE_PIXELS = 512    # pixels per tile (kMaxTilePixels in the .cu)
BWD_PIXELS = 2           # pixels per thread of the backward kernel (kPix)
# the cull box of `cull_box_torch` and `csrc/raster_common.cuh::cull_box`:
# slack on the threshold per unit of a·c/det (f32 rounding of the quadratic
# form, 4x its bound), the most slack it takes before it gives up, the
# margin in pixels, and the pixel coordinates it holds for, [0, CULL_SPAN)
CULL_SLACK = 64 * 2.0 ** -23
CULL_MAX_SLACK = 0.25
CULL_MARGIN = 1.0
CULL_SPAN = 65536.0
# plain versions: pairs per step of the blend, and the element budget of
# one (tiles, pixels, pairs) array — bounds its memory whatever a tile's
# depth. The forward's steps are all PLAIN_CHUNK long, the last padded: a
# tile's sums then do not depend on the tiles batched with it (a band
# render, `parallel/tiles.py`, is bitwise the frame's)
PLAIN_CHUNK = 256
PLAIN_MAX_ELEMS = 1 << 22


class RasterOutputs(NamedTuple):
    color: torch.Tensor                 # (H, W, C)
    invdepth: torch.Tensor              # (H, W)
    depth: torch.Tensor                 # (H, W)
    alpha: torch.Tensor                 # (H, W)
    n_contrib: Optional[torch.Tensor]   # (H, W) int32, training only
    log_t: Optional[torch.Tensor] = None  # (H, W) log T_final, training only


def _check(means2d, depths, conics, colors, opacities, ids, starts, counts,
           bg, width, height, tile_x, tile_y):
    P = means2d.shape[0]
    C = colors.shape[-1] if colors.ndim == 2 else -1
    shapes = {"means2d": (means2d, (P, 2)), "depths": (depths, (P,)),
              "conics": (conics, (P, 3)), "colors": (colors, (P, C)),
              "opacities": (opacities, (P,)), "bg": (bg, (C,))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    grid_x, grid_y = tile_grid(width, height, tile_x, tile_y)
    for name, t, n in (("ids", ids, ids.shape[0]),
                       ("tile_starts", starts, grid_x * grid_y),
                       ("tile_counts", counts, grid_x * grid_y)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: expected int32 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 1 <= C or C + 2 > MAX_PAYLOAD:
        raise ValueError(f"{C} colour channels: C + 2 must be <= "
                         f"{MAX_PAYLOAD}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad image size {width}x{height}")
    return C, grid_x, grid_y


def _device_of(args) -> torch.device:
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no rasterizer for device {dev}")
    return dev


def fwd_pixels(compute_n_contrib: bool) -> int:
    """Pixels per thread of the forward kernel: 2 in the training
    instantiation (the backward's layout), 4 in the inference one
    (`pixels_per_thread` in csrc/raster_fwd.cu)."""
    return 2 if compute_n_contrib else 4


def _check_tile(tile_x, tile_y, pixels, kernel):
    """The tiles a CUDA kernel with `pixels` rows per thread takes: at most
    MAX_TILE_PIXELS pixels, whole rows per thread and whole warps."""
    n = tile_x * tile_y
    if n > MAX_TILE_PIXELS or tile_y % pixels or (n // pixels) % 32:
        raise ValueError(f"tile {tile_x}x{tile_y}: the {kernel} kernel takes "
                         f"at most {MAX_TILE_PIXELS} pixels, {pixels} rows "
                         f"per thread and whole warps of threads")


def _check_contiguous(name, tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def rasterize_forward(means2d, depths, conics, colors, opacities, ids,
                      starts, counts, bg, width: int, height: int,
                      tile_x: int, tile_y: int,
                      compute_n_contrib: bool = False,
                      origin_y: int = 0) -> RasterOutputs:
    """Blend every tile's sorted pair range. CUDA tensors launch the kernel;
    CPU tensors run the plain version. `rasterize_forward.launches` counts
    kernel launches. `origin_y` is the image's first row in the frame's
    pixel coordinates (a band of the frame, `parallel/tiles.py`; the
    binning's `rows`)."""
    args = (means2d, depths, conics, colors, opacities, ids, starts, counts,
            bg)
    dev = _device_of(args)
    if dev.type == "cuda":
        return _rasterize_forward_cuda(*args, width, height, tile_x, tile_y,
                                       compute_n_contrib, origin_y)
    return rasterize_forward_torch(*args, width, height, tile_x, tile_y,
                                   compute_n_contrib, origin_y)


rasterize_forward.launches = 0


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int,
          trailing_ptrs: int = 1):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p] * trailing_ptrs)
    fn.restype = ctypes.c_int
    return fn


def _rasterize_forward_cuda(means2d, depths, conics, colors, opacities, ids,
                            starts, counts, bg, width, height, tile_x, tile_y,
                            compute_n_contrib, origin_y):
    C, grid_x, grid_y = _check(means2d, depths, conics, colors, opacities,
                               ids, starts, counts, bg, width, height,
                               tile_x, tile_y)
    _check_tile(tile_x, tile_y, fwd_pixels(compute_n_contrib), "forward")
    ins = (means2d, conics, opacities, colors, depths, ids, starts, counts,
           bg)
    _check_contiguous("rasterize_forward", ins)
    dev = means2d.device
    color = torch.empty((height, width, C), dtype=torch.float32, device=dev)
    invdepth = torch.empty((height, width), dtype=torch.float32, device=dev)
    depth = torch.empty_like(invdepth)
    alpha = torch.empty_like(invdepth)
    n_contrib = log_t = None
    if compute_n_contrib:
        n_contrib = torch.empty((height, width), dtype=torch.int32,
                                device=dev)
        log_t = torch.empty_like(invdepth)
    fn = _bind(load("raster_fwd"), "raster_fwd", 15, 9)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ins), color.data_ptr(),
                 invdepth.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
                 n_contrib.data_ptr() if compute_n_contrib else None,
                 log_t.data_ptr() if compute_n_contrib else None,
                 grid_x * grid_y, C, width, height, tile_x, tile_y, grid_x,
                 origin_y, int(compute_n_contrib), _stream(dev))
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: cudaError {err}")
    rasterize_forward.launches += 1
    return RasterOutputs(color, invdepth, depth, alpha, n_contrib, log_t)


def rasterize_forward_torch(means2d, depths, conics, colors, opacities, ids,
                            starts, counts, bg, width: int, height: int,
                            tile_x: int, tile_y: int,
                            compute_n_contrib: bool = False,
                            origin_y: int = 0) -> RasterOutputs:
    """Plain PyTorch version of the kernel, on any device.

    Tiles are taken in batches of similar pair counts (sorted by count), each
    batch's lists padded to its longest; the pair axis is walked in
    PLAIN_CHUNK pieces carrying (log_T, done) per pixel, so memory stays
    near PLAIN_MAX_ELEMS floats per (tiles, pixels, pairs) array whatever
    the depth of a tile. No per-tile clip."""
    C, grid_x, grid_y = _check(means2d, depths, conics, colors, opacities,
                               ids, starts, counts, bg, width, height,
                               tile_x, tile_y)
    dev = means2d.device
    num_tiles = grid_x * grid_y
    pix = tile_x * tile_y
    safe = torch.where(torch.isfinite(depths), depths,
                       torch.ones_like(depths))
    payload = torch.cat([colors, (1.0 / safe)[:, None], safe[:, None]], 1)

    lin = torch.arange(pix, device=dev)
    lx = (lin % tile_x).to(torch.float32)
    ly = (lin // tile_x).to(torch.float32)
    acc = torch.zeros((num_tiles, pix, C + 2), dtype=torch.float32,
                      device=dev)
    log_t = torch.zeros((num_tiles, pix), dtype=torch.float32, device=dev)
    n_con = torch.zeros((num_tiles, pix), dtype=torch.int32, device=dev)

    counts_l = counts.to(torch.int64)
    starts_l = starts.to(torch.int64)
    order = torch.argsort(counts_l, descending=True, stable=True)
    counts_sorted = counts_l[order].tolist()
    chunk = PLAIN_CHUNK
    tb = max(1, PLAIN_MAX_ELEMS // (pix * chunk))
    for b0 in range(0, num_tiles, tb):
        kmax = counts_sorted[b0]
        if kmax == 0:
            break
        tsel = order[b0:b0 + tb]
        B = tsel.shape[0]
        px = ((tsel % grid_x) * tile_x).to(torch.float32)[:, None] + lx
        py = ((tsel // grid_x) * tile_y
              + origin_y).to(torch.float32)[:, None] + ly
        cnt = counts_l[tsel]
        lt = torch.zeros((B, pix), dtype=torch.float32, device=dev)
        done = torch.zeros((B, pix), dtype=torch.bool, device=dev)
        acc_b = torch.zeros((B, pix, C + 2), dtype=torch.float32, device=dev)
        nc = torch.zeros((B, pix), dtype=torch.int32, device=dev)
        for k0 in range(0, kmax, chunk):
            k = torch.arange(k0, k0 + chunk, device=dev)
            valid = k[None, :] < cnt[:, None]                       # (B, K)
            slot = torch.clamp(starts_l[tsel][:, None] + k[None, :],
                               max=ids.shape[0] - 1)
            g = ids[slot].to(torch.int64)
            m = means2d[g]
            con = conics[g]
            dx = px[:, :, None] - m[:, None, :, 0]                  # (B, pix, K)
            dy = py[:, :, None] - m[:, None, :, 1]
            a = con[:, None, :, 0]
            b = con[:, None, :, 1]
            c = con[:, None, :, 2]
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = alpha_from_power(power, opacities[g][:, None, :])
            alpha = torch.where(valid[:, None, :], alpha,
                                torch.zeros_like(alpha))
            # chunk of the front-to-back blend, carrying (lt, done)
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
            if compute_n_contrib:
                nc += (contribute & valid[:, None, :]).sum(-1, dtype=torch.int32)
        acc[tsel] = acc_b
        log_t[tsel] = lt
        n_con[tsel] = nc

    t_final = torch.exp(log_t)
    color = acc[..., :C] + t_final[..., None] * bg
    tiles = torch.cat([color, acc[..., C:], (1.0 - t_final)[..., None],
                       n_con[..., None].to(torch.float32),
                       log_t[..., None]], dim=-1)
    img = _untile(tiles, width, height, tile_x, tile_y)
    return RasterOutputs(
        color=img[..., :C].contiguous(),
        invdepth=img[..., C].contiguous(),
        depth=img[..., C + 1].contiguous(),
        alpha=img[..., C + 2].contiguous(),
        n_contrib=(img[..., C + 3].to(torch.int32) if compute_n_contrib
                   else None),
        log_t=img[..., C + 4].contiguous() if compute_n_contrib else None)


def _untile(tiles, width, height, tile_x, tile_y):
    """(num_tiles, tile_x·tile_y, K) → (H, W, K)."""
    grid_x, grid_y = tile_grid(width, height, tile_x, tile_y)
    k = tiles.shape[-1]
    img = tiles.reshape(grid_y, grid_x, tile_y, tile_x, k)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * tile_y,
                                             grid_x * tile_x, k)
    return img[:height, :width]


def _tile(img, width, height, tile_x, tile_y):
    """(H, W, K) → (num_tiles, tile_x·tile_y, K), zero-padded to whole
    tiles (`raster_vjp._tile_pack`)."""
    grid_x, grid_y = tile_grid(width, height, tile_x, tile_y)
    k = img.shape[-1]
    img = torch.nn.functional.pad(
        img, (0, 0, 0, grid_x * tile_x - width, 0, grid_y * tile_y - height))
    img = img.reshape(grid_y, tile_y, grid_x, tile_x, k)
    return img.permute(0, 2, 1, 3, 4).reshape(grid_y * grid_x,
                                              tile_x * tile_y, k)


def cull_box_torch(means2d, conics, opacities) -> torch.Tensor:
    """(P, 4) float32 [x_lo, x_hi, y_lo, y_hi] per Gaussian: no pixel (x, y)
    with coordinates in [0, CULL_SPAN) outside the box passes the α ≥ 1/255
    test of `alpha_from_power` in f32. Plain version of the tile kernels'
    per-warp cull (`csrc/raster_common.cuh::cull_box`, the same
    arithmetic in the same order); used by the tests and `chip_smoke.py`.

    op·exp(power) ≥ 1/255 ⇔ ½dᵀQd ≤ t = ln(255·op), so |dx| ≤ √(2t·c/det)
    and |dy| ≤ √(2t·a/det) with Q = [[a, b], [b, c]], det = ac − b². t is
    raised by 1e-5 and by the factor 1 + 2·slack, slack = CULL_SLACK·ac/det,
    which covers the f32 rounding of the quadratic form (its terms reach
    4·ac/det times its value as det → 0) and of det; then one pixel of
    margin. The box is everything, (−inf, inf, −inf, inf), where it cannot
    say: an input NaN or inf, a ≤ 0, det ≤ 0, slack > CULL_MAX_SLACK, or a
    conic large enough to overflow the quadratic form. It is empty, (inf,
    −inf, inf, −inf), where op < 1/255 (finite inputs): no pixel passes."""
    mx, my = means2d[:, 0], means2d[:, 1]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    op = opacities
    det = a * c - b * b
    slack = CULL_SLACK * (a * c / det)
    t = (torch.log(255.0 * op) + 1e-5) * (1.0 + 2.0 * slack)
    rx = torch.sqrt(2.0 * t * c / det) + CULL_MARGIN
    ry = torch.sqrt(2.0 * t * a / det) + CULL_MARGIN
    box = torch.stack([mx - rx, mx + rx, my - ry, my + ry], 1)
    finite = (torch.isfinite(means2d).all(1) & torch.isfinite(conics).all(1)
              & torch.isfinite(op))
    span = mx.abs() + my.abs() + CULL_SPAN
    big = torch.maximum(torch.maximum(a, b.abs()), c) * span * span
    sure = (finite & (a > 0) & (det > 0) & (slack <= CULL_MAX_SLACK)
            & (big <= 1e37))
    inf = float("inf")
    every = torch.tensor([-inf, inf, -inf, inf], device=op.device)
    empty = torch.tensor([inf, -inf, inf, -inf], device=op.device)
    box = torch.where(sure[:, None], box, every)
    return torch.where((finite & (op < ALPHA_EPS))[:, None], empty, box)


def warp_pixels(tile_x: int, tile_y: int, pixels: int) -> torch.Tensor:
    """(warps, 32 · pixels) int64: the pixels (row-major index in the tile)
    that each warp of a tile kernel with `pixels` pixels per thread blends
    or replays (BWD_PIXELS for the backward, `fwd_pixels` for the forward).
    Thread t covers column t % tile_x of the rows pixels · (t // tile_x) + i,
    i < pixels; warp w holds threads 32w … 32w + 31."""
    t = torch.arange(tile_x * tile_y // pixels)
    rows = pixels * (t // tile_x)[:, None] + torch.arange(pixels)
    return (rows * tile_x + (t % tile_x)[:, None]).reshape(-1, 32 * pixels)


def warp_rects(tile_x: int, tile_y: int, pixels: int) -> torch.Tensor:
    """(warps, 4) int64 [x0, x1, y0, y1]: the pixel rectangle (inclusive,
    relative to the tile's origin) that holds each warp's pixels
    (`warp_pixels`; `csrc/raster_common.cuh::warp_rect`)."""
    pix = warp_pixels(tile_x, tile_y, pixels)
    x, y = pix % tile_x, pix // tile_x
    return torch.stack([x.amin(1), x.amax(1), y.amin(1), y.amax(1)], 1)


def rect_outside(box: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """Whether each pixel rectangle [x0, x1, y0, y1] lies outside the
    matching cull box (broadcast over leading dimensions)."""
    return ((rect[..., 1] < box[..., 0]) | (rect[..., 0] > box[..., 1])
            | (rect[..., 3] < box[..., 2]) | (rect[..., 2] > box[..., 3]))


def _check_backward(ids, log_t, n_contrib, g_color, g_invdepth, g_depth,
                    g_alpha, width, height, C):
    img = {"log_t": (log_t, torch.float32, (height, width)),
           "n_contrib": (n_contrib, torch.int32, (height, width)),
           "g_color": (g_color, torch.float32, (height, width, C)),
           "g_invdepth": (g_invdepth, torch.float32, (height, width)),
           "g_depth": (g_depth, torch.float32, (height, width)),
           "g_alpha": (g_alpha, torch.float32, (height, width))}
    for name, (t, dtype, shape) in img.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ids.device:
            raise ValueError(f"{name} on {t.device}, pairs on {ids.device}")


def rasterize_backward(means2d, depths, conics, colors, opacities, ids,
                       starts, counts, bg, log_t, n_contrib, g_color,
                       g_invdepth, g_depth, g_alpha, width: int,
                       height: int, tile_x: int, tile_y: int
                       ) -> torch.Tensor:
    """Per-pair gradients (n_pairs, C + 8), columns [mx, my, a, b, c,
    opacity, colors (C), invdepth, depth], from the forward's saved log_t
    and n_contrib and the image cotangents. CUDA tensors launch
    `csrc/raster_bwd.cu`; CPU tensors run `rasterize_backward_torch`.
    `rasterize_backward.launches` counts kernel launches."""
    args = (means2d, depths, conics, colors, opacities, ids, starts, counts,
            bg, log_t, n_contrib, g_color, g_invdepth, g_depth, g_alpha)
    dev = _device_of(args)
    fn = (_rasterize_backward_cuda if dev.type == "cuda"
          else rasterize_backward_torch)
    return fn(*args, width, height, tile_x, tile_y)


rasterize_backward.launches = 0


def _rasterize_backward_cuda(means2d, depths, conics, colors, opacities, ids,
                             starts, counts, bg, log_t, n_contrib, g_color,
                             g_invdepth, g_depth, g_alpha, width, height,
                             tile_x, tile_y):
    C, grid_x, grid_y = _check(means2d, depths, conics, colors, opacities,
                               ids, starts, counts, bg, width, height,
                               tile_x, tile_y)
    _check_backward(ids, log_t, n_contrib, g_color, g_invdepth, g_depth,
                    g_alpha, width, height, C)
    _check_tile(tile_x, tile_y, BWD_PIXELS, "backward")
    ins = (means2d, conics, opacities, colors, depths, ids, starts, counts,
           bg, log_t, n_contrib, g_color, g_invdepth, g_depth, g_alpha)
    _check_contiguous("rasterize_backward", ins)
    dev = means2d.device
    out = torch.empty((ids.shape[0], C + 8), dtype=torch.float32, device=dev)
    fn = _bind(load("raster_bwd"), "raster_bwd", 16, 7)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in ins), out.data_ptr(),
                 grid_x * grid_y, C, width, height, tile_x, tile_y, grid_x,
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"raster_bwd launch failed: cudaError {err}")
    rasterize_backward.launches += 1
    return out


def rasterize_backward_torch(means2d, depths, conics, colors, opacities, ids,
                             starts, counts, bg, log_t, n_contrib, g_color,
                             g_invdepth, g_depth, g_alpha, width: int,
                             height: int, tile_x: int, tile_y: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel, on any device.

    The kernel's recurrences as reverse cumulative sums (the formulation of
    `raster_bwd.py:183-279`): tiles in batches of similar pair counts, the
    pair axis walked back to front in PLAIN_CHUNK pieces carrying the
    running log-transmittance sum and the running suffix per pixel."""
    C, grid_x, grid_y = _check(means2d, depths, conics, colors, opacities,
                               ids, starts, counts, bg, width, height,
                               tile_x, tile_y)
    _check_backward(ids, log_t, n_contrib, g_color, g_invdepth, g_depth,
                    g_alpha, width, height, C)
    dev = means2d.device
    num_tiles = grid_x * grid_y
    pix = tile_x * tile_y
    safe = torch.where(torch.isfinite(depths), depths,
                       torch.ones_like(depths))
    payload = torch.cat([colors, (1.0 / safe)[:, None], safe[:, None]], 1)
    img = torch.cat([g_color, g_invdepth[..., None], g_depth[..., None],
                     g_alpha[..., None], log_t[..., None],
                     n_contrib[..., None].to(torch.float32)], -1)
    tiles = _tile(img, width, height, tile_x, tile_y)   # (T, pix, C + 5)
    g_t = tiles[..., :C + 2]
    back = torch.exp(tiles[..., C + 3]) * (
        (g_t[..., :C] * bg).sum(-1) - tiles[..., C + 2])
    log_tf = tiles[..., C + 3]
    nc = tiles[..., C + 4]

    lin = torch.arange(pix, device=dev)
    lx = (lin % tile_x).to(torch.float32)
    ly = (lin // tile_x).to(torch.float32)
    out = torch.zeros((ids.shape[0], C + 8), dtype=torch.float32,
                      device=dev)
    counts_l = counts.to(torch.int64)
    starts_l = starts.to(torch.int64)
    order = torch.argsort(counts_l, descending=True, stable=True)
    counts_sorted = counts_l[order].tolist()
    chunk = PLAIN_CHUNK
    tb = max(1, PLAIN_MAX_ELEMS // (pix * chunk))
    for b0 in range(0, num_tiles, tb):
        kmax = counts_sorted[b0]
        if kmax == 0:
            break
        tsel = order[b0:b0 + tb]
        B = tsel.shape[0]
        px = ((tsel % grid_x) * tile_x).to(torch.float32)[:, None] + lx
        py = ((tsel // grid_x) * tile_y).to(torch.float32)[:, None] + ly
        cnt = counts_l[tsel]
        gb, back_b, ltf_b, nc_b = g_t[tsel], back[tsel], log_tf[tsel], nc[tsel]
        c_log = torch.zeros((B, pix), dtype=torch.float32, device=dev)
        s_carry = torch.zeros((B, pix), dtype=torch.float32, device=dev)
        for k0 in reversed(range(0, kmax, chunk)):
            k = torch.arange(k0, min(k0 + chunk, kmax), device=dev)
            valid = k[None, :] < cnt[:, None]                        # (B, K)
            slot = torch.clamp(starts_l[tsel][:, None] + k[None, :],
                               max=max(ids.shape[0] - 1, 0))
            g = ids[slot].to(torch.int64)
            m = means2d[g]
            con = conics[g]
            dx = px[:, :, None] - m[:, None, :, 0]                   # (B, pix, K)
            dy = py[:, :, None] - m[:, None, :, 1]
            a = con[:, None, :, 0]
            b = con[:, None, :, 1]
            c = con[:, None, :, 2]
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
                / torch.clamp(1.0 - alpha, min=1e-6),
                torch.zeros_like(alpha))
            live = contrib & (alpha_raw <= ALPHA_MAX)
            zero = torch.zeros_like(alpha)
            q = torch.where(live, dalpha * alpha, zero)              # dL/dpower
            rows = torch.stack([
                (q * (a * dx + b * dy)).sum(1),
                (q * (c * dy + b * dx)).sum(1),
                (-0.5 * q * dx * dx).sum(1),
                (-q * dx * dy).sum(1),
                (-0.5 * q * dy * dy).sum(1),
                torch.where(live, dalpha * G, zero).sum(1)], -1)     # (B, K, 6)
            d_pay = torch.einsum("bpk,bpc->bkc", w, gb)              # (B, K, C+2)
            rows = torch.cat([rows, d_pay], -1)
            out[slot[valid]] = rows[valid]
            c_log = c_log + log1m.sum(-1)
            s_carry = s_carry + wgc.sum(-1)
    return out


def pairs_to_gaussians(pair_grads: torch.Tensor, ids: torch.Tensor,
                       gaussian_slots: torch.Tensor,
                       gaussian_offsets: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian sums (P, K) of the per-pair rows (n_pairs, K), P =
    len(gaussian_offsets) - 1, in a fixed order: on CUDA tensors one warp
    per Gaussian of `csrc/raster_bwd.cu` adds the Gaussian's slots in the
    order the binning lists them (`Binning.gaussian_slots`, ascending slot
    order; no sort here and no atomics, so the bits do not change from run
    to run); on CPU tensors `pairs_to_gaussians_torch`, which reads only
    `ids`. `pairs_to_gaussians.launches` counts kernel launches."""
    dev = _device_of((pair_grads, ids, gaussian_slots, gaussian_offsets))
    n = ids.shape[0]
    if pair_grads.dtype != torch.float32 or pair_grads.ndim != 2 \
            or pair_grads.shape[0] != n:
        raise ValueError(f"pair_grads: expected float32 ({n}, K), got "
                         f"{pair_grads.dtype} {tuple(pair_grads.shape)}")
    num_gaussians = max(gaussian_offsets.shape[0] - 1, 0)
    for name, t, shape in (("ids", ids, (n,)),
                           ("gaussian_slots", gaussian_slots, (n,)),
                           ("gaussian_offsets", gaussian_offsets,
                            (num_gaussians + 1,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dev.type == "cpu":
        return pairs_to_gaussians_torch(pair_grads, ids, num_gaussians)
    _check_contiguous("pairs_to_gaussians",
                      (pair_grads, gaussian_slots, gaussian_offsets))
    k = pair_grads.shape[1]
    out = torch.empty((num_gaussians, k), dtype=torch.float32, device=dev)
    fn = _bind(load("raster_bwd"), "segment_sum", 3, 2, trailing_ptrs=2)
    with torch.cuda.device(dev):
        err = fn(pair_grads.data_ptr(), gaussian_slots.data_ptr(),
                 gaussian_offsets.data_ptr(), num_gaussians, k,
                 out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    pairs_to_gaussians.launches += 1
    return out


pairs_to_gaussians.launches = 0


def pairs_to_gaussians_torch(pair_grads, ids, num_gaussians: int
                             ) -> torch.Tensor:
    """Plain version: `index_add_`, which on the CPU adds in index order."""
    out = torch.zeros((num_gaussians, pair_grads.shape[1]),
                      dtype=torch.float32, device=pair_grads.device)
    return out.index_add_(0, ids.to(torch.int64), pair_grads)


class RasterizeFunction(torch.autograd.Function):
    """Differentiable rasterizer with the gradient semantics of the JAX
    custom VJP (`raster_vjp.py:86-152`): the forward is the training
    instantiation (saves log T_final and n_contrib), the backward is the
    pair kernel and the fixed-order reduction to Gaussians, then
      d_depths = -d_invd/depth² + d_depth on finite depths, 0 elsewhere,
      d_bg     = Σ_pixels T_final · d_color.
    ids/starts/counts and the binning's gaussian_slots/gaussian_offsets
    (the order of the per-Gaussian sum) are integer binning outputs and get
    no gradient. The backward runs under the "grad/raster" span."""

    @staticmethod
    def forward(ctx, means2d, depths, conics, colors, opacities, ids, starts,
                counts, bg, gaussian_slots, gaussian_offsets, width, height,
                tile_x, tile_y):
        out = rasterize_forward(means2d, depths, conics, colors, opacities,
                                ids, starts, counts, bg, width, height,
                                tile_x, tile_y, compute_n_contrib=True)
        ctx.save_for_backward(means2d, depths, conics, colors, opacities,
                              ids, starts, counts, bg, gaussian_slots,
                              gaussian_offsets, out.log_t, out.n_contrib)
        ctx.dims = (width, height, tile_x, tile_y)
        return out.color, out.invdepth, out.depth, out.alpha

    @staticmethod
    def backward(ctx, d_color, d_invd, d_depth, d_alpha):
        with span("grad/raster"):
            (means2d, depths, conics, colors, opacities, ids, starts, counts,
             bg, slots, offsets, log_t, n_contrib) = ctx.saved_tensors
            C = colors.shape[-1]
            cot = [t.contiguous().to(torch.float32)
                   for t in (d_color, d_invd, d_depth, d_alpha)]
            pairs = rasterize_backward(means2d, depths, conics, colors,
                                       opacities, ids, starts, counts, bg,
                                       log_t, n_contrib, *cot, *ctx.dims)
            per = pairs_to_gaussians(pairs, ids, slots, offsets)
            finite = torch.isfinite(depths)
            safe = torch.where(finite, depths, torch.ones_like(depths))
            d_depths = torch.where(
                finite, -per[:, 6 + C] / (safe * safe) + per[:, 7 + C],
                torch.zeros_like(depths))
            d_bg = (torch.exp(log_t)[..., None] * cot[0]).sum((0, 1))
            return (per[:, 0:2], d_depths, per[:, 2:5], per[:, 6:6 + C],
                    per[:, 5], None, None, None, d_bg, None, None, None,
                    None, None, None)


def make_rasterizer(width: int, height: int, channels: int,
                    inference: bool = True, tile_x: int = 32,
                    tile_y: int = 16):
    """Rasterizer closure for one image size, with the signature and output
    of the JAX `make_pallas_rasterizer` closures, plus what the backward's
    per-Gaussian sum reads of the binning:
    f(means2d, depths, conics, colors, opacities, ids, starts, counts, bg,
      gaussian_slots=None, gaussian_offsets=None)
      → (color, invdepth, depth, alpha).
    inference=False returns the differentiable one (`RasterizeFunction`),
    which needs `Binning.gaussian_slots` and `Binning.gaussian_offsets`;
    the inference one does not read them."""

    def rasterize(means2d, depths, conics, colors, opacities, ids, starts,
                  counts, bg, gaussian_slots=None, gaussian_offsets=None):
        if colors.shape[-1] != channels:
            raise ValueError(f"expected {channels} channels, got "
                             f"{colors.shape[-1]}")
        if not inference:
            if gaussian_slots is None or gaussian_offsets is None:
                raise ValueError("the differentiable rasterizer needs the "
                                 "binning's gaussian_slots and "
                                 "gaussian_offsets")
            return RasterizeFunction.apply(
                means2d, depths, conics, colors, opacities, ids, starts,
                counts, bg, gaussian_slots, gaussian_offsets, width, height,
                tile_x, tile_y)
        out = rasterize_forward(means2d, depths, conics, colors, opacities,
                                ids, starts, counts, bg, width, height,
                                tile_x, tile_y, compute_n_contrib=False)
        return out.color, out.invdepth, out.depth, out.alpha

    return rasterize
