"""Forward tile rasterizer: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/pallas/raster.py` plus the
inference closure of `ops/pallas/raster_vjp.py:38-78`. `rasterize_forward`
is the one wrapper: on CUDA tensors it launches `csrc/raster_fwd.cu` (or
raises), on CPU tensors it runs `rasterize_forward_torch`. There is no
fallback from one to the other.

Inputs are per-Gaussian arrays plus the binning of `ops/binning.py`:
  means2d (P, 2), depths (P,), conics (P, 3), colors (P, C), opacities (P,)
  float32; ids (n_pairs,), tile_starts/tile_counts (num_tiles,) int32;
  bg (C,) float32.
Outputs are images: color (H, W, C), invdepth, depth, alpha (H, W) and,
for the training instantiation, n_contrib (H, W) int32 — every pair before
the sticky stop, skipped pairs included, which the backward replays.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._build import load
from .binning import tile_grid
from .blending import LOG_T_EPS, alpha_from_power

MAX_PAYLOAD = 8          # C colours + inverse depth + depth
MAX_TILE_PIXELS = 512    # one thread per pixel (kMaxTilePixels in the .cu)
# plain version: pairs per step of the blend, and the element budget of one
# (tiles, pixels, pairs) array — bounds its memory whatever a tile's depth
PLAIN_CHUNK = 256
PLAIN_MAX_ELEMS = 1 << 22


class RasterOutputs(NamedTuple):
    color: torch.Tensor                 # (H, W, C)
    invdepth: torch.Tensor              # (H, W)
    depth: torch.Tensor                 # (H, W)
    alpha: torch.Tensor                 # (H, W)
    n_contrib: Optional[torch.Tensor]   # (H, W) int32, training only


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


def rasterize_forward(means2d, depths, conics, colors, opacities, ids,
                      starts, counts, bg, width: int, height: int,
                      tile_x: int, tile_y: int,
                      compute_n_contrib: bool = False) -> RasterOutputs:
    """Blend every tile's sorted pair range. CUDA tensors launch the kernel;
    CPU tensors run the plain version. `rasterize_forward.launches` counts
    kernel launches."""
    args = (means2d, depths, conics, colors, opacities, ids, starts, counts,
            bg)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return _rasterize_forward_cuda(*args, width, height, tile_x, tile_y,
                                       compute_n_contrib)
    if dev.type == "cpu":
        return rasterize_forward_torch(*args, width, height, tile_x, tile_y,
                                       compute_n_contrib)
    raise ValueError(f"no rasterizer for device {dev}")


rasterize_forward.launches = 0


def _bind(lib: ctypes.CDLL):
    fn = lib.raster_fwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rasterize_forward_cuda(means2d, depths, conics, colors, opacities, ids,
                            starts, counts, bg, width, height, tile_x, tile_y,
                            compute_n_contrib):
    C, grid_x, grid_y = _check(means2d, depths, conics, colors, opacities,
                               ids, starts, counts, bg, width, height,
                               tile_x, tile_y)
    n = tile_x * tile_y
    if n > MAX_TILE_PIXELS or n % 32:
        raise ValueError(f"tile {tile_x}x{tile_y}: pixels per tile must be a "
                         f"multiple of 32 and <= {MAX_TILE_PIXELS}")
    ins = (means2d, conics, opacities, colors, depths, ids, starts, counts,
           bg)
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("rasterize_forward: inputs must be contiguous")
    dev = means2d.device
    color = torch.empty((height, width, C), dtype=torch.float32, device=dev)
    invdepth = torch.empty((height, width), dtype=torch.float32, device=dev)
    depth = torch.empty_like(invdepth)
    alpha = torch.empty_like(invdepth)
    n_contrib = (torch.empty((height, width), dtype=torch.int32, device=dev)
                 if compute_n_contrib else None)
    fn = _bind(load("raster_fwd"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), color.data_ptr(),
                 invdepth.data_ptr(), depth.data_ptr(), alpha.data_ptr(),
                 n_contrib.data_ptr() if n_contrib is not None else None,
                 grid_x * grid_y, C, width, height, tile_x, tile_y, grid_x,
                 int(compute_n_contrib), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed: cudaError {err}")
    rasterize_forward.launches += 1
    return RasterOutputs(color, invdepth, depth, alpha, n_contrib)


def rasterize_forward_torch(means2d, depths, conics, colors, opacities, ids,
                            starts, counts, bg, width: int, height: int,
                            tile_x: int, tile_y: int,
                            compute_n_contrib: bool = False) -> RasterOutputs:
    """Plain PyTorch version of the kernel, on any device.

    Tiles are taken in batches of similar pair counts (sorted by count), each
    batch's lists padded to its longest; the pair axis is walked in
    PLAIN_CHUNK pieces carrying (log_T, done) per pixel, so memory stays near
    PLAIN_MAX_ELEMS floats per (tiles, pixels, pairs) array whatever the
    depth of a tile. No per-tile clip."""
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
        py = ((tsel // grid_x) * tile_y).to(torch.float32)[:, None] + ly
        cnt = counts_l[tsel]
        lt = torch.zeros((B, pix), dtype=torch.float32, device=dev)
        done = torch.zeros((B, pix), dtype=torch.bool, device=dev)
        acc_b = torch.zeros((B, pix, C + 2), dtype=torch.float32, device=dev)
        nc = torch.zeros((B, pix), dtype=torch.int32, device=dev)
        for k0 in range(0, kmax, chunk):
            k = torch.arange(k0, min(k0 + chunk, kmax), device=dev)
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
                       n_con[..., None].to(torch.float32)], dim=-1)
    img = tiles.reshape(grid_y, grid_x, tile_y, tile_x, C + 4)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * tile_y,
                                             grid_x * tile_x, C + 4)
    img = img[:height, :width]
    return RasterOutputs(
        color=img[..., :C].contiguous(),
        invdepth=img[..., C].contiguous(),
        depth=img[..., C + 1].contiguous(),
        alpha=img[..., C + 2].contiguous(),
        n_contrib=(img[..., C + 3].to(torch.int32) if compute_n_contrib
                   else None))


def make_rasterizer(width: int, height: int, channels: int,
                    inference: bool = True, tile_x: int = 32,
                    tile_y: int = 16):
    """Rasterizer closure for one image size, with the signature and output
    of the JAX `rasterize_inf`:
    f(means2d, depths, conics, colors, opacities, ids, starts, counts, bg)
      → (color, invdepth, depth, alpha).
    Only the inference closure exists so far: the differentiable one comes
    with the backward kernel."""
    if not inference:
        raise NotImplementedError(
            "the differentiable rasterizer needs the backward kernel "
            "(ROADMAP Queue 2, K3), which is not ported yet")

    def rasterize_inf(means2d, depths, conics, colors, opacities, ids,
                      starts, counts, bg):
        if colors.shape[-1] != channels:
            raise ValueError(f"expected {channels} channels, got "
                             f"{colors.shape[-1]}")
        out = rasterize_forward(means2d, depths, conics, colors, opacities,
                                ids, starts, counts, bg, width, height,
                                tile_x, tile_y, compute_n_contrib=False)
        return out.color, out.invdepth, out.depth, out.alpha

    return rasterize_inf
