"""f32 operations that a training step and an inference frame need,
counted from the formulas: one operation per arithmetic operation or
function evaluation on one value, reductions one add per value summed.
Comparisons, casts and selections are not counted, so the figure is the
least the formulas ask, not what an implementation issues.
"""

from __future__ import annotations

from .raster import blend_ops, bwd_ops_per_contrib

# Per Gaussian, the projection of `reference/render.py::project` at SH
# degree 3 and C = 3 (its own lines, in order):
PROJECTION_FWD = {
    "activations": 3 + 1,           # exp of 3 log scales, sigmoid
    "view and clip transforms": 21 + 28,   # 3 + 4 rows of a 4x4 product
    "perspective divide": 2 + 2,
    "quaternion normalise": 14,
    "rotation matrix": 30,
    "squared scales": 3,
    "3D covariance": 48,            # 6 entries x (6 mul + 2 add)
    "Jacobian and clamps": 17 + 18,
    "2D covariance": 60,            # three quadratic forms
    "dilation, determinant, conic": 13,
    "radius": 12,
    "pixel centre": 8,
    "tile rect": 20,
    "view direction": 13,
    "SH degree 3, 16 coefficients": 141 + 6,   # basis and sums, +0.5, clamp
    "opacity rect": 16,
}
# The gradient of the differentiable part (all but the radius, the rects
# and the opacity rect): two operations per forward one, the rule for
# chains of elementwise arithmetic in reverse mode.
_NO_GRAD = ("radius", "tile rect", "opacity rect")
PROJECTION_BWD_PER_FWD = 2
# The SH band mask of a training step (the 45 higher coefficients of
# degree 3, each multiplied by its band's 0 or 1).
SH_MASK = 45


def projection_fwd_ops() -> int:
    return sum(PROJECTION_FWD.values())


def projection_bwd_ops() -> int:
    return PROJECTION_BWD_PER_FWD * (sum(
        v for k, v in PROJECTION_FWD.items() if k not in _NO_GRAD) + SH_MASK)


# Per pixel of a C = 3 image, forward and backward of the losses:
# L1 (difference, abs, sum; its gradient 2 a value); SSIM's five 11x11
# grouped convolutions (2 x 121 per output value), its elementwise map
# (20 a value) and the gradients of the three convolutions of the render
# and of the map; for LGDWT-GS the two Haar levels of render and target
# (5 a value each), the subband L1s, the ELF map (its Haar level, sums
# and bilinear upsampling), the patches' Haar level and L1, and their
# gradients.
LOSS_L1 = 3 * 3 + 2 * 3
LOSS_SSIM = 5 * 3 * 242 + 20 * 3 + 3 * 3 * 242 + 20 * 3
LOSS_DWT = 2 * 5 * 3 + 7 + 30 + 2 * 5 * 3 + 10 + 2 * (5 * 3 + 7 + 5 * 3 + 10)


def loss_ops_per_pixel(dwt: bool) -> int:
    return LOSS_L1 + LOSS_SSIM + (LOSS_DWT if dwt else 0)


# Per parameter value, Adam: first moment 3, second 4, the update 7.
ADAM = 3 + 4 + 7


def train_step_ops(P: int, n_values: int, width: int, height: int,
                   dwt: bool, contrib: int, stops: int, n_pairs: int,
                   C: int = 3) -> int:
    """One training step of one view: projection and its gradient per
    Gaussian, the blend forward and backward per contributing evaluation
    and the per-Gaussian sum of the pair rows, the losses per pixel, Adam
    per parameter value (`n_values` of them)."""
    return (P * (projection_fwd_ops() + SH_MASK + projection_bwd_ops())
            + blend_ops(C, contrib, stops)
            + contrib * bwd_ops_per_contrib(C) + n_pairs * (C + 8)
            + width * height * loss_ops_per_pixel(dwt)
            + n_values * ADAM)


def frame_ops(P: int, contrib: int, stops: int, C: int = 3) -> int:
    """One inference frame: the projection of every Gaussian and the
    forward blend."""
    return P * projection_fwd_ops() + blend_ops(C, contrib, stops)
