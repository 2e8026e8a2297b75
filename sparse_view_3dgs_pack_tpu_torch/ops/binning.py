"""Tile binning: (tile, Gaussian) pair expansion, depth sort, tile ranges.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/binning.py:40-226,307-314` and
of the CUDA pipeline `duplicateWithKeys → radix sort → identifyTileRanges`
(`rasterizer_impl.cu:70-138,306-317`). Eager PyTorch sizes the pair buffer
from the exact per-frame count, as CUDA's `resizeFunctional` does, so there
is no static `max_pairs` bucket — at the cost of one host sync per frame
for the count.

The sorted order is the JAX one exactly: the key is
`(tile << depth_bits) | top-depth_bits(f32 bits of depth)` with
`depth_bits = min(32 - tile_bits, 22)`, pairs are expanded Gaussian by
Gaussian and, within one, over the row-major tiles of its rect, and the
sort is stable — so equal keys keep that expansion order, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.tracing import span

TILE = 16


class Binning(NamedTuple):
    ids: torch.Tensor          # (total_pairs,) int32 Gaussian id, sorted by (tile, depth)
    tile_starts: torch.Tensor  # (num_tiles,) int32
    tile_counts: torch.Tensor  # (num_tiles,) int32
    total_pairs: int           # exact pair count (host int)
    # the sort's permutation (slot -> expanded pair) and where each
    # Gaussian's expanded pairs start: what the backward's per-Gaussian
    # order is made of (`gaussian_slots`, `gaussian_offsets`)
    order: torch.Tensor        # (total_pairs,) int64
    pair_starts: torch.Tensor  # (P,) int64, exclusive cumsum of pair counts

    @property
    def gaussian_slots(self) -> torch.Tensor:
        """(total_pairs,) int32: each Gaussian's pair slots in ascending slot
        order, Gaussian by Gaussian (= torch.sort(ids, stable=True).indices),
        the fixed order of the backward's per-Gaussian sum. Pairs were
        expanded Gaussian by Gaussian, each over its tiles in ascending tile
        id, and slots are tile-major: so this is the inverse of `order`, one
        scatter. Computed where it is read, by the training render only."""
        n = self.total_pairs
        slots = torch.empty(n, dtype=torch.int32, device=self.order.device)
        slots[self.order] = torch.arange(n, dtype=torch.int32,
                                         device=self.order.device)
        return slots

    @property
    def gaussian_offsets(self) -> torch.Tensor:
        """(P + 1,) int32: where each Gaussian's run starts in
        `gaussian_slots`, with total_pairs appended."""
        return torch.nn.functional.pad(self.pair_starts, (0, 1),
                                       value=self.total_pairs).to(torch.int32)


def tile_grid(width: int, height: int, tile: int = TILE,
              tile_y: int | None = None):
    """Tile grid dims; rectangular tiles via `tile_y` (x size = `tile`)."""
    ty = tile if tile_y is None else tile_y
    return (width + tile - 1) // tile, (height + ty - 1) // ty


def _split_radii(radii: torch.Tensor):
    """radii as (P,) square half-side or (P, 2) per-axis [rx, ry]. Returns
    f32 rx, ry and the liveness mask (every axis positive)."""
    if radii.ndim == 2:
        return (radii[:, 0].to(torch.float32), radii[:, 1].to(torch.float32),
                torch.amin(radii, dim=1) > 0)
    r = radii.to(torch.float32)
    return r, r, radii > 0


def _trunc_clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    """int32(v) clipped to [0, hi], as the JAX `astype(int32)` + clip.
    Clamping to [-1, hi] first keeps the cast in range (truncation toward
    zero maps everything below -1 to <= -1, which the clip sends to 0)."""
    return torch.clamp(torch.clamp(v, -1.0, float(hi)).to(torch.int32), 0, hi)


def gaussian_rects(means2d, radii, width, height, tile: int = TILE,
                   tile_y: int | None = None):
    """Clamped tile rect per Gaussian (reference `getRect`,
    `cuda_rasterizer/auxiliary.h`); radii may be per-axis (P, 2)."""
    ty = tile if tile_y is None else tile_y
    grid_x, grid_y = tile_grid(width, height, tile, ty)
    rx, ry, _ = _split_radii(radii)
    min_x = _trunc_clip((means2d[:, 0] - rx) / tile, grid_x)
    max_x = _trunc_clip((means2d[:, 0] + rx + tile - 1) / tile, grid_x)
    min_y = _trunc_clip((means2d[:, 1] - ry) / ty, grid_y)
    max_y = _trunc_clip((means2d[:, 1] + ry + ty - 1) / ty, grid_y)
    return min_x, max_x, min_y, max_y


def _key_bits(num_tiles: int):
    """Bit split for the packed sort key: [tile_id | depth_bits]. Depth bits
    are the top bits of the positive-f32 bit pattern (monotone in depth),
    capped at 22 as in the JAX package."""
    tile_bits = max(1, num_tiles.bit_length())
    depth_bits = min(32 - tile_bits, 22)
    return tile_bits, depth_bits


def depth_key(depths: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Top `depth_bits` bits of the f32 pattern of the depth (0 for non-finite
    depths) as int64 — the low field of the sort key."""
    d = torch.where(torch.isfinite(depths), depths,
                    torch.zeros_like(depths)).to(torch.float32)
    bits = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (32 - depth_bits)


def _touched(means2d, radii, width, height, tile, tile_y, rows=None):
    min_x, max_x, min_y, max_y = gaussian_rects(means2d, radii, width,
                                                height, tile, tile_y)
    if rows is not None:
        # the band's tile rows [row0, row0 + n), in frame coordinates: the
        # rects are the frame's, cut to the band in integers
        row0, n = rows
        min_y = torch.clamp(min_y - row0, 0, n)
        max_y = torch.clamp(max_y - row0, 0, n)
    _, _, live = _split_radii(radii)
    rect_w = max_x - min_x
    touched = torch.where(live, rect_w * (max_y - min_y),
                          torch.zeros_like(rect_w))
    return touched, min_x, min_y, rect_w


def bin_gaussians(means2d, depths, radii, width: int, height: int,
                  tile: int = TILE, tile_y: int | None = None,
                  rows: tuple[int, int] | None = None) -> Binning:
    """Sorted pair list and per-tile ranges for one frame. `rows` = (row0,
    n) bins only the band of tile rows [row0, row0 + n) of the frame (rows
    past the frame's last are empty), tile ids counted from the band's
    first row: each of its tiles gets the frame's pairs in the frame's
    order (the sort key keeps the frame's depth bits), which the band
    render of `parallel/tiles.py` relies on."""
    dev = means2d.device
    P = means2d.shape[0]
    grid_x, grid_y = tile_grid(width, height, tile, tile_y)
    _, depth_bits = _key_bits(grid_x * grid_y)
    if rows is not None:
        grid_y = rows[1]
    num_tiles = grid_x * grid_y

    touched, min_x, min_y, rect_w = _touched(means2d, radii, width, height,
                                             tile, tile_y, rows)
    touched = touched.to(torch.int64)
    with span("sync/binning_count"):
        total = int(touched.sum())     # the per-frame host sync
    if total == 0:
        zeros = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
        return Binning(ids=torch.zeros(0, dtype=torch.int32, device=dev),
                       tile_starts=zeros, tile_counts=zeros.clone(),
                       total_pairs=0,
                       order=torch.zeros(0, dtype=torch.int64, device=dev),
                       pair_starts=torch.zeros(P, dtype=torch.int64,
                                               device=dev))

    gid = torch.repeat_interleave(torch.arange(P, device=dev), touched,
                                  output_size=total)
    offsets = torch.cumsum(touched, 0) - touched          # exclusive
    j = torch.arange(total, device=dev) - offsets[gid]    # index in the rect
    rw = rect_w.to(torch.int64)[gid]
    jq = torch.div(j, rw, rounding_mode="floor")
    tile_id = ((min_y.to(torch.int64)[gid] + jq) * grid_x
               + min_x.to(torch.int64)[gid] + (j - jq * rw))
    key = (tile_id << depth_bits) | depth_key(depths, depth_bits)[gid]
    _, order = torch.sort(key, stable=True)

    # bincount reads the ids' least and largest on the host
    with span("sync/binning_tiles"):
        counts = torch.bincount(tile_id, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    return Binning(ids=gid[order].to(torch.int32),
                   tile_starts=starts.to(torch.int32),
                   tile_counts=counts.to(torch.int32),
                   total_pairs=total, order=order, pair_starts=offsets)


def count_pairs(means2d, depths, radii, width, height, tile: int = TILE,
                tile_y: int | None = None) -> int:
    """Exact pair count of one frame."""
    touched, _, _, _ = _touched(means2d, radii, width, height, tile, tile_y)
    return int(touched.to(torch.int64).sum())
