"""Instant-NGP multiresolution hash-grid encoding, plain PyTorch.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/hashgrid.py` (reference CUDA
`gridencoder`, `DNGaussian/gridencoder/src/gridencoder.cu`): 16 levels × 2
features, a 2^19 table, resolutions growing from the base to the desired
one, trilinear interpolation of the 8 cell corners, xor-prime hashing where
a level does not fit the table densely. The JAX package computes it in XLA
with no Pallas kernel, and so does the port: each corner is one gather over
every level at once, and autograd's scatter-add of that gather is the
table's gradient (the CUDA backward's atomicAdd sum, in another order).

The hash is taken in int64: the low bits of the int64 products equal the
uint32 wrap-around products of the JAX package, so `& (T - 1)` gives the
same index, and no product reaches 2^41.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.tracing import span

_PRIMES = (1, 2654435761, 805459861)


class HashGridConfig(NamedTuple):
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 512

    @property
    def output_dim(self):
        return self.num_levels * self.level_dim

    def resolutions(self):
        if self.num_levels == 1:
            return [self.base_resolution]
        b = np.exp(np.log(self.desired_resolution / self.base_resolution)
                   / (self.num_levels - 1))
        return [int(np.floor(self.base_resolution * b ** l))
                for l in range(self.num_levels)]


def init_hashgrid(generator: torch.Generator,
                  cfg: HashGridConfig = HashGridConfig(),
                  scale: float = 1e-4) -> torch.Tensor:
    """(num_levels, 2^log2_hashmap_size, level_dim) uniform in [-scale,
    scale] (torch-ngp init), drawn from `generator` on its device."""
    size = 1 << cfg.log2_hashmap_size
    u = torch.rand((cfg.num_levels, size, cfg.level_dim),
                   generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * scale


def _level_constants(cfg: HashGridConfig, device):
    """Per level, as (L, 1) tensors: the resolution (float and int64), the
    dense grid's stride, whether the level is indexed densely, and the
    level's row offset in the flattened table. Five copies of host
    numbers to the device, each of which waits for it (the span
    "sync/grid_levels")."""
    table_size = 1 << cfg.log2_hashmap_size
    res = cfg.resolutions()
    col = lambda v, dt: torch.tensor(v, dtype=dt, device=device)[:, None]
    with span("sync/grid_levels"):
        return (col(res, torch.float32), col(res, torch.int64),
                col([r + 1 for r in res], torch.int64),
                col([(r + 1) ** 3 <= table_size for r in res], torch.bool),
                col([l * table_size for l in range(len(res))], torch.int64))


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig = HashGridConfig(),
                    bound: float = 1.0) -> torch.Tensor:
    """x: (N, 3) in [-bound, bound] → (N, num_levels·level_dim), level by
    level. `table` (num_levels, 2^log2_hashmap_size, level_dim)."""
    n = x.shape[0]
    mask = (1 << cfg.log2_hashmap_size) - 1
    res_f, res_i, stride, dense, base = _level_constants(cfg, x.device)
    u = torch.clamp((x + bound) / (2.0 * bound), 0.0, 1.0)   # (N, 3)
    pos = u[None] * res_f[..., None]                          # (L, N, 3)
    pos0 = torch.minimum(torch.clamp(torch.floor(pos).to(torch.int64),
                                     min=0), (res_i - 1)[..., None])
    # pos0 is clamped before frac, so frac reaches 1 on the upper face
    frac = pos - pos0.to(torch.float32)
    flat = table.reshape(-1, cfg.level_dim)
    feat = None
    for cx in (0, 1):
        wx = (1 - frac[..., 0]) if cx == 0 else frac[..., 0]
        for cy in (0, 1):
            wy = (1 - frac[..., 1]) if cy == 0 else frac[..., 1]
            for cz in (0, 1):
                wz = (1 - frac[..., 2]) if cz == 0 else frac[..., 2]
                ix, iy, iz = (pos0[..., 0] + cx, pos0[..., 1] + cy,
                              pos0[..., 2] + cz)
                hashed = ((ix * _PRIMES[0]) ^ (iy * _PRIMES[1])
                          ^ (iz * _PRIMES[2])) & mask
                idx = torch.where(dense, (ix * stride + iy) * stride + iz,
                                  hashed)
                term = (wx * wy * wz)[..., None] * flat[idx + base]
                feat = term if feat is None else feat + term   # (L, N, F)
    return feat.permute(1, 0, 2).reshape(n, -1)
