"""Probe kernels: the hand-written CUDA kernels of `csrc/probes.cu` and,
beside each, its plain PyTorch version.

Counterpart of the Pallas probes `scripts/tpu_prims.py` (P1-P4) and
`scripts/tpu_dbg.py` (D1, D2). Each checks one primitive the forward
rasterizer is built from, or dumps what the rasterizer computes per tile,
so that a rasterizer fault on the card can be bisected
(`python -m sparse_view_3dgs_pack_tpu_torch.probes.prims|fwd_bisect`).
  tile_coords  P1  pixel (x, y) of a grid of 16x16 tiles
  row_cumsum   P2  row-wise inclusive scan
  offset_copy  P3  data[:, s:s+width] for starts read on the device
  pair_alpha   P4  alpha of every (pixel, pair) of a tile at the origin
  tile_alpha   D1  per-tile (pixel, pair) alpha of its first 256 pairs
  tile_blend   D2  per-tile one-batch blend: payload sums, log T, n_contrib
Each wrapper dispatches on the device of its tensors: on CUDA tensors it
launches its kernel (or raises), on CPU tensors it runs its plain version
(`<name>_torch`). There is no fallback from one to the other. Each
wrapper's `launches` counts its kernel launches.

D1 and D2 take the port's own pair list, as the forward kernel does:
per-Gaussian means2d (P, 2), depths (P,), conics (P, 3), colors (P, C),
opacities (P,) float32 and the 16x16 binning's ids / tile_starts /
tile_counts int32 (`ops/binning.py`); they return (num_tiles, 256, 256)
float32, rows pixels p (x = p % 16, y = p // 16 in the tile), columns
lanes (D1: the tile's pairs 0..255) or results (D2: columns 0-7 sum
w * payload over C colours, 1/depth, depth and zeros, column 8 log T,
column 9 the lanes that pass the ln 1e-4 test, the rest zero).
"""

from __future__ import annotations

import torch

from ._build import load
from .binning import tile_grid
from .blending import ALPHA_EPS, ALPHA_MAX, LOG_T_EPS
from .raster import (MAX_PAYLOAD, _bind, _check_contiguous, _device_of,
                     _stream)

TILE = 16
PIX = TILE * TILE        # pixels of a tile
CHUNK = 256              # pairs per batch
BLEND_COLS = 10          # D2: 8 payload sums, log T, n_contrib
MAX_SCAN_COLS = 1024     # P2: one thread per element of a row
MAX_COPY_BYTES = 48 * 1024   # P3: rows x width in one block's shared memory
# plain versions: elements of one (tiles, pixels, pairs) array
PLAIN_MAX_ELEMS = 1 << 24


def _launch(name: str, dev, ptrs, ints) -> None:
    fn = _bind(load("probes"), name, len(ptrs), len(ints))
    with torch.cuda.device(dev):
        err = fn(*ptrs, *ints, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _expect(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _pixels(tiles: torch.Tensor, grid_x: int):
    """(len(tiles), PIX) float pixel x and y of each tile's pixels."""
    p = torch.arange(PIX, device=tiles.device)
    ox = ((tiles % grid_x) * TILE).to(torch.float32)[:, None]
    oy = ((tiles // grid_x) * TILE).to(torch.float32)[:, None]
    return (ox + (p % TILE).to(torch.float32)[None],
            oy + (p // TILE).to(torch.float32)[None])


def _power(px, py, mx, my, a, b, c):
    dx = px - mx
    dy = py - my
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def _raw_alpha(power, op):
    return torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)),
                       max=ALPHA_MAX)


def _masked_alpha(power, op, valid):
    alpha = _raw_alpha(power, op)
    return torch.where((power > 0.0) | (alpha < ALPHA_EPS) | ~valid,
                       torch.zeros_like(alpha), alpha)


# ---- P1 ---------------------------------------------------------------------

def tile_coords(n_tiles: int = 8, grid_x: int = 4,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """(n_tiles, 256, 2) float32 pixel (x, y) of tiles laid out row-major
    over `grid_x` columns (tpu_prims.py:18 `k_iota`: 8 tiles, 4 across).
    `device` cuda launches the kernel, cpu runs `tile_coords_torch`."""
    dev = torch.device(device)
    if n_tiles < 0 or grid_x <= 0:
        raise ValueError(f"bad tile grid: {n_tiles} tiles, {grid_x} across")
    if dev.type == "cpu":
        return tile_coords_torch(n_tiles, grid_x, dev)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernels for device {dev}")
    out = torch.empty((n_tiles, PIX, 2), dtype=torch.float32, device=dev)
    _launch("probe_tile_coords", dev, [out.data_ptr()], [n_tiles, grid_x])
    tile_coords.launches += 1
    return out


tile_coords.launches = 0


def tile_coords_torch(n_tiles: int = 8, grid_x: int = 4,
                      device: str | torch.device = "cpu") -> torch.Tensor:
    px, py = _pixels(torch.arange(n_tiles, device=device), grid_x)
    return torch.stack([px, py], -1)


# ---- P2 ---------------------------------------------------------------------

def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of each row of a (rows, cols) float32 tensor, cols a
    multiple of 32 up to 1024 (tpu_prims.py:44 `k_cumsum`, a triangular
    matmul on the TPU; a warp-shuffle scan here)."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x: expected float32 (rows, cols), got {x.dtype} "
                         f"{tuple(x.shape)}")
    dev = _device_of((x,))
    if dev.type == "cpu":
        return row_cumsum_torch(x)
    rows, cols = x.shape
    if cols % 32 or not 0 < cols <= MAX_SCAN_COLS:
        raise ValueError(f"{cols} columns: must be a multiple of 32 and <= "
                         f"{MAX_SCAN_COLS}")
    _check_contiguous("row_cumsum", (x,))
    out = torch.empty_like(x)
    _launch("probe_row_cumsum", dev, [x.data_ptr(), out.data_ptr()],
            [rows, cols])
    row_cumsum.launches += 1
    return out


row_cumsum.launches = 0


def row_cumsum_torch(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1)


# ---- P3 ---------------------------------------------------------------------

def offset_copy(data: torch.Tensor, starts: torch.Tensor,
                width: int = CHUNK) -> torch.Tensor:
    """(len(starts), rows, width): data[:, s:s+width] for each start s of
    an int32 device tensor, columns outside the data read as 0
    (tpu_prims.py:68 `k_dma`). The kernel reads the starts itself, so each
    copy's offset is known only on the device."""
    if data.dtype != torch.float32 or data.ndim != 2:
        raise ValueError(f"data: expected float32 (rows, cols), got "
                         f"{data.dtype} {tuple(data.shape)}")
    if starts.dtype != torch.int32 or starts.ndim != 1:
        raise ValueError(f"starts: expected int32 (n,), got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    dev = _device_of((data, starts))
    if dev.type == "cpu":
        return offset_copy_torch(data, starts, width)
    rows, cols = data.shape
    if width <= 0 or rows * width * 4 > MAX_COPY_BYTES:
        raise ValueError(f"{rows} rows x {width} columns do not fit one "
                         f"block's {MAX_COPY_BYTES} bytes")
    _check_contiguous("offset_copy", (data, starts))
    out = torch.empty((starts.shape[0], rows, width), dtype=torch.float32,
                      device=dev)
    _launch("probe_offset_copy", dev,
            [data.data_ptr(), starts.data_ptr(), out.data_ptr()],
            [starts.shape[0], rows, cols, width,
             int(data.data_ptr() % 16 == 0)])
    offset_copy.launches += 1
    return out


offset_copy.launches = 0


def offset_copy_torch(data: torch.Tensor, starts: torch.Tensor,
                      width: int = CHUNK) -> torch.Tensor:
    cols = starts.to(torch.int64)[:, None] + torch.arange(
        width, device=data.device)[None]
    inside = (cols >= 0) & (cols < data.shape[1])
    got = data[:, cols.clamp(0, data.shape[1] - 1)]      # (rows, n, width)
    got = torch.where(inside[None], got, torch.zeros_like(got))
    return got.permute(1, 0, 2).contiguous()


# ---- P4 ---------------------------------------------------------------------

def pair_alpha(d: torch.Tensor) -> torch.Tensor:
    """(256, n) alpha = min(0.99, op exp(min(power, 0))) of the pixels of a
    16x16 tile at the origin against n pairs, no skip mask; `d` is
    (>= 6, n) float32 with rows mx, my, conic a, b, c, opacity
    (tpu_prims.py:93 `k_alpha`)."""
    if d.dtype != torch.float32 or d.ndim != 2 or d.shape[0] < 6 \
            or d.shape[1] == 0:
        raise ValueError(f"d: expected float32 (>= 6, n >= 1), got {d.dtype} "
                         f"{tuple(d.shape)}")
    dev = _device_of((d,))
    if dev.type == "cpu":
        return pair_alpha_torch(d)
    _check_contiguous("pair_alpha", (d,))
    out = torch.empty((PIX, d.shape[1]), dtype=torch.float32, device=dev)
    _launch("probe_pair_alpha", dev, [d.data_ptr(), out.data_ptr()],
            [d.shape[1]])
    pair_alpha.launches += 1
    return out


pair_alpha.launches = 0


def pair_alpha_torch(d: torch.Tensor) -> torch.Tensor:
    px, py = _pixels(torch.zeros(1, dtype=torch.int64, device=d.device), 1)
    power = _power(px[0][:, None], py[0][:, None], *d[:5, None, :])
    return _raw_alpha(power, d[5][None])


# ---- D1, D2: the pair list --------------------------------------------------

def _check_pairs(means2d, depths, conics, colors, opacities, ids, starts,
                 counts, width, height):
    P = means2d.shape[0]
    for name, t, shape in (("means2d", means2d, (P, 2)),
                           ("depths", depths, (P,)),
                           ("conics", conics, (P, 3)),
                           ("opacities", opacities, (P,))):
        if t is not None:
            _expect(name, t, torch.float32, shape)
    C = 0
    if colors is not None:
        C = colors.shape[-1] if colors.ndim == 2 else 0
        _expect("colors", colors, torch.float32, (P, C))
        if not 1 <= C or C + 2 > MAX_PAYLOAD:
            raise ValueError(f"{C} colour channels: C + 2 must be <= "
                             f"{MAX_PAYLOAD}")
    grid_x, grid_y = tile_grid(width, height, TILE, TILE)
    num_tiles = grid_x * grid_y
    if ids.dtype != torch.int32 or ids.ndim != 1:
        raise ValueError(f"ids: expected int32 (n_pairs,), got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    _expect("tile_starts", starts, torch.int32, (num_tiles,))
    _expect("tile_counts", counts, torch.int32, (num_tiles,))
    return C, grid_x, num_tiles


def _lane_pairs(ids, starts, counts, tiles, lanes):
    """Gaussian id of lanes `lanes` of each tile in `tiles` and whether the
    lane holds a pair: (len(tiles), len(lanes)) each."""
    valid = lanes[None, :] < counts.to(torch.int64)[tiles][:, None]
    slot = starts.to(torch.int64)[tiles][:, None] + lanes[None, :]
    slot = slot.clamp(0, max(ids.shape[0] - 1, 0))
    g = (ids[slot].to(torch.int64) if ids.shape[0]
         else torch.zeros_like(slot))
    return g, valid


def tile_alpha(means2d, conics, opacities, ids, starts, counts, width: int,
               height: int, walk_all: bool = False) -> torch.Tensor:
    """D1 (tpu_dbg.py:54 `make_kernel(with_loop)` -> `kern`): each 16x16
    tile's (pixel, lane) alpha over its first 256 pairs, zero where
    power > 0, alpha < 1/255 or the lane is past the tile's pair count.
    `walk_all` (the TPU's `with_loop`) streams every batch of 256 pairs, up
    to 64, through the kernel's two-stage cp.async ring and keeps batch 0:
    the same bits. CPU tensors run `tile_alpha_torch`."""
    _, grid_x, num_tiles = _check_pairs(means2d, None, conics, None,
                                        opacities, ids, starts, counts,
                                        width, height)
    ins = (means2d, conics, opacities, ids, starts, counts)
    dev = _device_of(ins)
    if dev.type == "cpu":
        return tile_alpha_torch(*ins, width, height)
    _check_contiguous("tile_alpha", ins)
    out = torch.empty((num_tiles, PIX, CHUNK), dtype=torch.float32,
                      device=dev)
    _launch("probe_tile_alpha", dev,
            [t.data_ptr() for t in ins] + [out.data_ptr()],
            [num_tiles, grid_x, int(walk_all)])
    tile_alpha.launches += 1
    return out


tile_alpha.launches = 0


def tile_alpha_torch(means2d, conics, opacities, ids, starts, counts,
                     width: int, height: int) -> torch.Tensor:
    """Plain version of D1 (tiles in batches of PLAIN_MAX_ELEMS
    elements)."""
    _, grid_x, num_tiles = _check_pairs(means2d, None, conics, None,
                                        opacities, ids, starts, counts,
                                        width, height)
    dev = means2d.device
    out = torch.empty((num_tiles, PIX, CHUNK), dtype=torch.float32,
                      device=dev)
    lanes = torch.arange(CHUNK, device=dev)
    tb = max(1, PLAIN_MAX_ELEMS // (PIX * CHUNK))
    for t0 in range(0, num_tiles, tb):
        tiles = torch.arange(t0, min(t0 + tb, num_tiles), device=dev)
        g, valid = _lane_pairs(ids, starts, counts, tiles, lanes)
        px, py = _pixels(tiles, grid_x)
        m, con = means2d[g], conics[g]                   # (B, K, ...)
        power = _power(px[:, :, None], py[:, :, None],
                       m[:, None, :, 0], m[:, None, :, 1],
                       con[:, None, :, 0], con[:, None, :, 1],
                       con[:, None, :, 2])
        out[tiles] = _masked_alpha(power, opacities[g][:, None, :],
                                   valid[:, None, :])
    return out


def tile_blend(means2d, depths, conics, colors, opacities, ids, starts,
               counts, width: int, height: int) -> torch.Tensor:
    """D2 (tpu_dbg.py:141 `blend_kernel`): each tile's blend of its first
    256 pairs (one batch) by the script's non-sticky test, w = alpha ·
    exp(exclusive Σ log1p(-alpha)) while the inclusive sum >= ln 1e-4.
    Columns: 0-7 Σ w · [colors (C), 1/depth, depth, zeros], 8 log T,
    9 the lanes that pass (masked lanes included), the rest 0. CPU
    tensors run `tile_blend_torch`."""
    C, grid_x, num_tiles = _check_pairs(means2d, depths, conics, colors,
                                        opacities, ids, starts, counts,
                                        width, height)
    ins = (means2d, conics, opacities, colors, depths, ids, starts, counts)
    dev = _device_of(ins)
    if dev.type == "cpu":
        return tile_blend_torch(means2d, depths, conics, colors, opacities,
                                ids, starts, counts, width, height)
    _check_contiguous("tile_blend", ins)
    out = torch.empty((num_tiles, PIX, CHUNK), dtype=torch.float32,
                      device=dev)
    _launch("probe_tile_blend", dev,
            [t.data_ptr() for t in ins] + [out.data_ptr()],
            [num_tiles, C, grid_x])
    tile_blend.launches += 1
    return out


tile_blend.launches = 0


def tile_blend_torch(means2d, depths, conics, colors, opacities, ids,
                     starts, counts, width: int, height: int,
                     lanes: int = CHUNK) -> torch.Tensor:
    """Plain version of D2, the lanes walked in order as the kernel walks
    them. `lanes` = 512 blends two batches: the expectation that the
    forward kernel is held to on tiles of at most 512 pairs."""
    C, grid_x, num_tiles = _check_pairs(means2d, depths, conics, colors,
                                        opacities, ids, starts, counts,
                                        width, height)
    dev = means2d.device
    safe = torch.where(torch.isfinite(depths), depths,
                       torch.ones_like(depths))
    payload = torch.cat([colors, (1.0 / safe)[:, None], safe[:, None]], 1)
    tiles = torch.arange(num_tiles, device=dev)
    g, valid = _lane_pairs(ids, starts, counts, tiles,
                           torch.arange(lanes, device=dev))
    px, py = _pixels(tiles, grid_x)
    acc = torch.zeros((num_tiles, PIX, C + 2), dtype=torch.float32,
                      device=dev)
    s_all = torch.zeros((num_tiles, PIX), dtype=torch.float32, device=dev)
    log_t = torch.zeros_like(s_all)
    nc = torch.zeros_like(s_all)
    for j in range(lanes):
        gj = g[:, j]
        m, con = means2d[gj], conics[gj]
        power = _power(px, py, m[:, None, 0], m[:, None, 1],
                       con[:, None, 0], con[:, None, 1], con[:, None, 2])
        alpha = _masked_alpha(power, opacities[gj][:, None],
                              valid[:, j, None])
        s_incl = s_all + torch.log1p(-alpha)
        passing = s_incl >= LOG_T_EPS
        w = torch.where(passing, alpha * torch.exp(s_all),
                        torch.zeros_like(alpha))
        acc += w[..., None] * payload[gj][:, None, :]
        log_t = torch.where(passing, s_incl, log_t)
        nc += passing.to(torch.float32)
        s_all = s_incl
    out = torch.zeros((num_tiles, PIX, CHUNK), dtype=torch.float32,
                      device=dev)
    out[..., :C + 2] = acc
    out[..., 8] = log_t
    out[..., 9] = nc
    return out
