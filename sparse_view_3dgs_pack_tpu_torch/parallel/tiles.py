"""Band-parallel (image-space) rendering over several devices.

Counterpart of `sparse_view_3dgs_pack_tpu/parallel/tiles.py`. The
Gaussians are projected once; each device gets a copy of the projected
tensors and renders one horizontal band of whole tile rows: band b covers
the frame's rows [b·band_h, (b+1)·band_h), band_h = ceil(grid_y / n)·16
at the inference tiles (32×16, `renderer.py`), so a trailing band may be
empty padding. The bands are gathered on the first device and cropped to
the frame's height. A list may name one device several times; the bands
then run one after the other there.

Where JAX shifts `means2d` into band-local y, the port bins the band's tile
rows in frame coordinates (`bin_gaussians(rows=...)`: the frame's rects and
depth-key bits, cut to the band in integers) and the forward kernel takes
the band's first row (`origin_y`): no mean is shifted, so none is rounded,
and each band pixel sees the frame's pairs in the frame's order. The band
render is bitwise the single-device one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.binning import bin_gaussians, tile_grid
from ..ops.projection import Projected
from ..ops.raster import rasterize_forward


class BandOutputs(NamedTuple):
    color: torch.Tensor     # (H, W, C)
    invdepth: torch.Tensor  # (H, W)
    depth: torch.Tensor     # (H, W)
    alpha: torch.Tensor     # (H, W)
    band_pairs: list        # each band's exact pair count


def band_rows(height: int, n_bands: int, tile_y: int) -> int:
    """Tile rows per band: the frame's tile rows over `n_bands`, rounded
    up."""
    return -(-tile_grid(1, height, 1, tile_y)[1] // n_bands)


def render_tile_parallel(proj: Projected, width: int, height: int,
                         background, devices, tile_x: int = 32,
                         tile_y: int = 16) -> BandOutputs:
    """The frame of `proj` rendered band by band, band b on `devices[b]`,
    gathered on `devices[0]`; the outputs of the inference rasterizer."""
    devices = [torch.device(d) for d in devices]
    rows = band_rows(height, len(devices), tile_y)
    bands, pairs = [], []
    for b, dev in enumerate(devices):
        p = Projected(*[t if t is None else t.to(dev) for t in proj])
        ba = bin_gaussians(p.means2d, p.depths, p.rect_radii, width, height,
                           tile_x, tile_y, rows=(b * rows, rows))
        bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
        out = rasterize_forward(
            p.means2d.contiguous(), p.depths.contiguous(),
            p.conics.contiguous(), p.colors.contiguous(),
            p.opacities.contiguous(), ba.ids, ba.tile_starts, ba.tile_counts,
            bg, width, rows * tile_y, tile_x, tile_y,
            origin_y=b * rows * tile_y)
        bands.append(out)
        pairs.append(ba.total_pairs)
    first = devices[0]
    gather = [torch.cat([getattr(o, f).to(first) for o in bands])[:height]
              for f in ("color", "invdepth", "depth", "alpha")]
    return BandOutputs(*gather, band_pairs=pairs)


def make_tile_parallel_render_fn(devices, width: int, height: int):
    """Drop-in for `renderer.render` (`render.py --tile_parallel`):
    fn(model, camera, bg_color, sh_degree_active=None, antialiasing=False,
    **ignored) → RenderResult, the model on `devices[0]`. Other keywords
    (`scaling_modifier` among them) are ignored, as the JAX drop-in's
    `**_ignored` does."""
    from ..renderer import (INFER_TILE_X, INFER_TILE_Y, RenderResult,
                            project_params)

    def fn(model, camera, bg_color, sh_degree_active=None,
           antialiasing=False, **_ignored):
        if sh_degree_active is None:
            sh_degree_active = model.max_sh_degree
        with torch.no_grad():
            proj = project_params(model.params(), camera.params(), width,
                                  height, sh_degree_active,
                                  antialiasing=antialiasing)
            out = render_tile_parallel(proj, width, height, bg_color,
                                       devices, INFER_TILE_X, INFER_TILE_Y)
        return RenderResult(
            render=torch.clamp(out.color, 0.0, 1.0), radii=proj.radii,
            depth=out.invdepth, alpha=out.alpha, expected_depth=out.depth,
            n_pairs=max(out.band_pairs))

    return fn
