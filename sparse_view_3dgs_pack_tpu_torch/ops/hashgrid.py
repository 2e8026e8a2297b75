"""Instant-NGP multiresolution hash-grid encoding.

Counterpart of `sparse_view_3dgs_pack_tpu/ops/hashgrid.py` (reference CUDA
`gridencoder`, `DNGaussian/gridencoder/src/gridencoder.cu`): 16 levels × 2
features, a 2^19 table, resolutions growing from the base to the desired
one, trilinear interpolation of the 8 cell corners, xor-prime hashing where
a level does not fit the table densely.

The JAX package computes it in XLA with no Pallas kernel. The port's plain
version, `hashgrid_encode_torch`, does the same in PyTorch: each corner is
one gather over every level at once, and autograd's scatter-add of that
gather is the table's gradient. Its hash is taken in int64: the low bits of
the int64 products equal the uint32 wrap-around products of the JAX
package, so `& (T - 1)` gives the same index, and no product reaches 2^41.

On CUDA tensors the encode is one `torch.autograd.Function`,
`HashGridFunction`: a hand-written forward and backward kernel
(`csrc/hashgrid.cu`, the reference's design) that save only their inputs.
`hashgrid_encode` is the one place that chooses by the device of its
tensors, with no fallback from one path to the other: CUDA tensors take
`HashGridFunction`, CPU tensors `hashgrid_encode_torch` under autograd.
`HashGridFunction`, `hashgrid_forward` (`hashgrid_fwd_kernel`) and
`hashgrid_backward` (`hashgrid_bwd_kernel`) take CUDA tensors only;
`hashgrid_forward.launches` and `hashgrid_backward.launches` count their
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.tracing import span
from ._build import load

_PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 32           # as csrc/hashgrid.cu's kMaxLevels
LEVEL_DIMS = (1, 2, 4, 8)  # the kernels' instantiations
MAX_LOG2_SIZE = 30
MAX_POINTS = 2 ** 31 - 256   # the kernels' int point index, a block's room


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
    "sync/grid_levels"); the kernels take them by value instead."""
    table_size = 1 << cfg.log2_hashmap_size
    res = cfg.resolutions()
    col = lambda v, dt: torch.tensor(v, dtype=dt, device=device)[:, None]
    with span("sync/grid_levels"):
        return (col(res, torch.float32), col(res, torch.int64),
                col([r + 1 for r in res], torch.int64),
                col([(r + 1) ** 3 <= table_size for r in res], torch.bool),
                col([l * table_size for l in range(len(res))], torch.int64))


def hashgrid_encode_torch(table: torch.Tensor, x: torch.Tensor,
                          cfg: HashGridConfig = HashGridConfig(),
                          bound: float = 1.0) -> torch.Tensor:
    """The plain composition, differentiable by autograd. x: (N, 3) in
    [-bound, bound] → (N, num_levels·level_dim), level by level. `table`
    (num_levels, 2^log2_hashmap_size, level_dim)."""
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


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig = HashGridConfig(),
                    bound: float = 1.0) -> torch.Tensor:
    """x: (N, 3) in [-bound, bound] → (N, num_levels·level_dim), level by
    level, differentiable in `table` (num_levels, 2^log2_hashmap_size,
    level_dim) and `x`: on CUDA tensors `HashGridFunction` (the two
    kernels), otherwise the plain composition under autograd."""
    if table.device.type == "cuda" or x.device.type == "cuda":
        return HashGridFunction.apply(table, x, cfg, bound)
    return hashgrid_encode_torch(table, x, cfg, bound)


# ---------------------------------------------------------------------------
# The kernels


@functools.lru_cache(maxsize=None)
def _levels(cfg: HashGridConfig) -> tuple:
    """Each level's resolution and whether it is indexed densely, as the
    host arrays the C entries read, made once per configuration; or
    ValueError where the kernels do not take `cfg`."""
    if cfg.level_dim not in LEVEL_DIMS:
        raise ValueError(f"level_dim {cfg.level_dim}: the hash-grid kernels "
                         f"take {LEVEL_DIMS}")
    if not 1 <= cfg.num_levels <= MAX_LEVELS or not (
            1 <= cfg.log2_hashmap_size <= MAX_LOG2_SIZE):
        raise ValueError(f"{cfg.num_levels} levels of 2^"
                         f"{cfg.log2_hashmap_size} rows: the hash-grid "
                         f"kernels take 1 to {MAX_LEVELS} levels of at most "
                         f"2^{MAX_LOG2_SIZE}")
    res = cfg.resolutions()
    if min(res) < 1:
        raise ValueError(f"resolutions {res}: each must be ≥ 1")
    dense = [int((r + 1) ** 3 <= 1 << cfg.log2_hashmap_size) for r in res]
    arr = ctypes.c_int * len(res)
    return arr(*res), arr(*dense)


def _check_inputs(table: torch.Tensor, x: torch.Tensor,
                  cfg: HashGridConfig) -> None:
    """ValueError where the kernels do not take `table` and `x`: float32,
    contiguous, on one device, x (N, 3), the table shaped as `cfg` says
    and aligned for its rows' vector loads, a configuration the kernels
    are instantiated for (`_levels`)."""
    _levels(cfg)
    shape = (cfg.num_levels, 1 << cfg.log2_hashmap_size, cfg.level_dim)
    for name, t, want in (("table", table, shape),
                          ("x", x, (x.shape[0] if x.ndim else 0, 3))):
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(
                f"hash grid {name}: expected contiguous float32 {want} on "
                f"{table.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}" + ("" if t.is_contiguous()
                                 else " (not contiguous)"))
    if x.shape[0] > MAX_POINTS:
        raise ValueError(f"{x.shape[0]} points: the hash-grid kernels take "
                         f"at most {MAX_POINTS}")
    if table.data_ptr() % (4 * min(cfg.level_dim, 4)):
        raise ValueError("hash grid table: its rows are not aligned for "
                         f"{cfg.level_dim}-float vector loads")


def _check_card(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> None:
    """`_check_inputs`, and ValueError on tensors off the card: the kernels
    have no CPU path (`hashgrid_encode` runs the plain composition
    there)."""
    if table.device.type != "cuda":
        raise ValueError(f"hash grid kernels: CUDA tensors only, got the "
                         f"table on {table.device}")
    _check_inputs(table, x, cfg)


def _scalars(bound: float) -> tuple:
    """bound and 1 / (2·bound) as the plain version's float32s on the card:
    PyTorch's CUDA division by a Python number multiplies by the float32
    reciprocal of its float32."""
    return (float(np.float32(bound)),
            float(np.float32(1.0) / np.float32(2.0 * bound)))


def _lib():
    lib = load("hashgrid")
    if not getattr(lib, "hashgrid_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hashgrid_fwd.argtypes = [vp, vp, vp] + [ci] * 4 + [vp, vp, cf,
                                                              cf, vp]
        lib.hashgrid_bwd.argtypes = [vp] * 5 + [ci] * 4 + [vp, vp, cf, cf,
                                                          vp]
        lib.hashgrid_fwd.restype = lib.hashgrid_bwd.restype = ci
        lib.hashgrid_typed = True
    return lib


def _grid_args(x: torch.Tensor, cfg: HashGridConfig, bound: float) -> tuple:
    res, dense = _levels(cfg)
    return ((x.shape[0], cfg.num_levels, cfg.level_dim,
             cfg.log2_hashmap_size, res, dense) + _scalars(bound))


def hashgrid_forward(table: torch.Tensor, x: torch.Tensor,
                     cfg: HashGridConfig = HashGridConfig(),
                     bound: float = 1.0) -> torch.Tensor:
    """The encode's values (N, num_levels·level_dim), without autograd:
    one launch of `hashgrid_fwd_kernel` on CUDA tensors (`_check_card`).
    `hashgrid_forward.launches` counts the launches."""
    _check_card(table, x, cfg)
    dev = x.device
    out = torch.empty((x.shape[0], cfg.output_dim), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = _lib().hashgrid_fwd(table.data_ptr(), x.data_ptr(),
                                  out.data_ptr(), *_grid_args(x, cfg, bound),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hashgrid_fwd launch failed: cudaError {err}")
    hashgrid_forward.launches += 1
    return out


hashgrid_forward.launches = 0


def hashgrid_backward(table: torch.Tensor, x: torch.Tensor,
                      grad_out: torch.Tensor,
                      cfg: HashGridConfig = HashGridConfig(),
                      bound: float = 1.0, need_x: bool = True
                      ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the table's gradient, x's or None unless `need_x`) from the
    gradient `grad_out` (N, num_levels·level_dim) of the encode: one
    launch of `hashgrid_bwd_kernel` on CUDA tensors (`_check_card`).
    `hashgrid_backward.launches` counts the launches."""
    _check_card(table, x, cfg)
    dev = x.device
    want = (x.shape[0], cfg.output_dim)
    if (grad_out.dtype != torch.float32 or tuple(grad_out.shape) != want
            or grad_out.device != dev):
        raise ValueError(f"hash grid gradient: expected float32 {want} on "
                         f"{dev}, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    grad_out = grad_out.contiguous()
    if grad_out.data_ptr() % (4 * min(cfg.level_dim, 4)):
        grad_out = grad_out.clone()   # a view at an odd offset
    grad_table = torch.empty_like(table)
    grad_x = torch.empty_like(x) if need_x else None
    with torch.cuda.device(dev):
        err = _lib().hashgrid_bwd(
            table.data_ptr(), x.data_ptr(), grad_out.data_ptr(),
            grad_table.data_ptr(),
            None if grad_x is None else grad_x.data_ptr(),
            *_grid_args(x, cfg, bound),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hashgrid_bwd launch failed: cudaError {err}")
    hashgrid_backward.launches += 1
    return grad_table, grad_x


hashgrid_backward.launches = 0


class HashGridFunction(torch.autograd.Function):
    """The encode on CUDA tensors, forward and backward each one kernel
    (`hashgrid_forward`, `hashgrid_backward`). Only the table and the
    points are saved: the backward recomputes each corner and weight. The
    points' gradient is computed only where autograd asks for it; as
    autograd's of the plain composition it passes where the clamp to
    [0, 1] does, its ends included."""

    @staticmethod
    def forward(ctx, table, x, cfg, bound):
        ctx.save_for_backward(table, x)
        ctx.cfg, ctx.bound = cfg, bound
        return hashgrid_forward(table, x, cfg, bound)

    @staticmethod
    def backward(ctx, grad_out):
        table, x = ctx.saved_tensors
        need_table, need_x = ctx.needs_input_grad[:2]
        g_table, g_x = hashgrid_backward(table, x, grad_out, ctx.cfg,
                                         ctx.bound, need_x)
        return g_table if need_table else None, g_x, None, None
