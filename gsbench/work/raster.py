"""Operations and bytes of the tile rasterizer's kernels, and the least
time they allow.

Copied from the arithmetic of `chip_smoke.py` (`bound`, `SKIP_OPS`,
`fwd_ops_per_contrib`, `blend_ops`, `bwd_ops_per_contrib` and the byte
counts of `_fwd_bound`, `_bwd_bound`, `_segsum_bound`) and frozen here.
The (pair, pixel) counts come from the reference's replay of the same
inputs (`reference.render.Work`), not from the kernel's `n_contrib`, so
the count stays the same whatever implements the kernel. Bytes count
each input byte read once and each output byte written once.
"""

from __future__ import annotations

from .peaks import PEAK_BYTES, PEAK_F32_OPS

# f32 operations of a skipped evaluation (power > 0 or alpha < 1/255):
# offsets 2, quadratic form 9, clamp/exp/opacity/clamp 4, the two tests 2
SKIP_OPS = 17


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(least seconds, what sets it): bytes at the HBM rate or f32
    operations at the f32 peak, whichever takes longer."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_ops / PEAK_F32_OPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fwd_ops_per_contrib(C: int) -> int:
    """Per contributing (pair, pixel) of the forward: offsets 2, quadratic
    form 9, clamp/exp/opacity/clamp 4, log1p and its add 2, the weight and
    the transmittance's update 2, payload FMAs 2(C + 2)."""
    return 2 + 9 + 4 + 2 + 2 + 2 * (C + 2)


def blend_ops(C: int, contrib: int, stops: int) -> int:
    """The forward's operations: each contributing (pair, pixel), and each
    pixel's stop (the evaluation that stops it, SKIP_OPS + 3: log1p, its
    add, the stop test)."""
    return contrib * fwd_ops_per_contrib(C) + stops * (SKIP_OPS + 3)


def bwd_ops_per_contrib(C: int) -> int:
    """Per contributing (pair, pixel) of the backward: the forward's alpha
    15, log1p/sum 2, T 2, weight 1, <g, payload> 2(C + 2), dL/dalpha 6,
    suffix 2, payload gradients C + 2, geometry gradients 19, one add per
    value of the reduction over pixels C + 8."""
    return 15 + 2 + 2 + 1 + 2 * (C + 2) + 6 + 2 + (C + 2) + 19 + (C + 8)


def _inputs_bytes(P: int, C: int, n_pairs: int, tiles: int) -> int:
    """Per-Gaussian inputs (means 2, depth 1, conic 3, colours C, opacity
    1), the pair ids, tile starts and counts, the background."""
    return (P * (2 + 1 + 3 + C + 1) + n_pairs + 2 * tiles + C) * 4


def fwd_bound(P: int, C: int, n_pairs: int, tiles: int, W: int, H: int,
              contrib: int, stops: int, training: bool) -> tuple:
    """The forward kernel: images out (colour C, inverse depth, depth,
    alpha; in training also n_contrib and log T)."""
    n_bytes = _inputs_bytes(P, C, n_pairs, tiles) \
        + W * H * (C + 3 + (2 if training else 0)) * 4
    return bound(n_bytes, blend_ops(C, contrib, stops))


def bwd_bound(P: int, C: int, n_pairs: int, tiles: int, W: int, H: int,
              contrib: int) -> tuple:
    """K3: the forward's inputs, log T, n_contrib and the image cotangents
    (C + 3) in, a row of C + 8 gradients per pair out."""
    n_bytes = (_inputs_bytes(P, C, n_pairs, tiles) + W * H * (C + 5) * 4
               + n_pairs * (C + 8) * 4)
    return bound(n_bytes, contrib * bwd_ops_per_contrib(C))


def segsum_bound(P: int, K: int, n_pairs: int) -> tuple:
    """The per-Gaussian sum of the pair rows: rows and slots in, offsets
    in, one row per Gaussian out; one add per value."""
    n_bytes = n_pairs * (K + 1) * 4 + (P + 1) * 4 + P * K * 4
    return bound(n_bytes, n_pairs * K)
