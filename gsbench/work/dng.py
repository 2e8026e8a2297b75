"""f32 operations and bytes of a DNGaussian iteration, counted from the
formulas of `reference/dng.py` (the rules of `step.py`: one operation per
arithmetic operation or function evaluation on one value, reductions one
add per value summed; comparisons, casts, integer hashing and selections
not counted; a gradient two operations per forward one), whatever
implements them.

The neural field, per Gaussian and evaluation, at the configuration's
widths (`cfg["field"]`): the hash encode (per level, the position 3, its
fraction 3, the complements 3; per corner the weight 2 and, per feature,
a product and a sum), the two MLPs (a multiply and an add per weight, an
add per bias), the view direction, its SH-4 basis, the colour activation
and the opacity product. Its bytes: the 8 corners' features of every
level read from the table, the mean and the opacity in, the colour and the
opacity out (the MLPs' weights, read once, left out).
"""

from __future__ import annotations

from .peaks import PEAK_BYTES, PEAK_F32_OPS
from .raster import blend_ops, bwd_ops_per_contrib
from .step import (ADAM, LOSS_L1, LOSS_SSIM, PROJECTION_BWD_PER_FWD,
                   PROJECTION_FWD, SH_MASK)

# the view direction: difference 3, norm 3 + 2 + 1, division 3; its SH-4
# basis (16 values): the products x², y², z², xy, yz, xz 6 and the
# polynomials 30; the colour activation sigmoid, scale, shift a channel 9;
# the opacity: two sigmoids and their product 3
FIELD_DIRS, FIELD_SH4, FIELD_COLOR_ACT, FIELD_OPACITY = 12, 36, 9, 3
# the encode's input: (x - centre + bound) / 2·bound 4 a coordinate
FIELD_INPUT = 12


def mlp_dims(f: dict) -> tuple:
    sigma = ([f["num_levels"] * f["level_dim"]] + [f["hidden_dim"]]
             * (f["num_layers_sigma"] - 1) + [1 + f["geo_feat_dim"]])
    color = ([f["sh_degree"] ** 2 + f["geo_feat_dim"]]
             + [f["hidden_dim_color"]] * (f["num_layers_color"] - 1) + [3])
    return sigma, color


def mlp_ops(dims: list) -> int:
    """A multiply and an add per weight, an add per bias."""
    return sum(2 * a * b + b for a, b in zip(dims, dims[1:]))


def encode_ops(f: dict) -> int:
    per_level = 3 + 3 + 3 + 8 * (2 + 2 * f["level_dim"])
    return FIELD_INPUT + f["num_levels"] * per_level


def field_fwd_ops(f: dict) -> int:
    """f32 operations of one evaluation of the field, per Gaussian."""
    sigma, color = mlp_dims(f)
    return (encode_ops(f) + mlp_ops(sigma) + mlp_ops(color) + FIELD_DIRS
            + FIELD_SH4 + FIELD_COLOR_ACT + FIELD_OPACITY)


def field_bytes(f: dict) -> int:
    """Bytes of one evaluation of the field, per Gaussian: the table's
    corner features, the mean (3) and opacity (1) in, the colour (3) and
    opacity (1) out."""
    return 4 * (f["num_levels"] * 8 * f["level_dim"] + 3 + 1 + 3 + 1)


def field_bound(P: int, f: dict) -> tuple:
    """(least seconds of one evaluation of P Gaussians, what sets it)."""
    t_bytes = P * field_bytes(f) / PEAK_BYTES
    t_ops = P * field_fwd_ops(f) / PEAK_F32_OPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# The projection with the colours and opacities given: `step.py`'s
# projection less the view direction, the SH colour and the opacity's
# sigmoid. Its gradient counts the differentiable part; the hard pass's
# (only the means learn) leaves out what depends on the scales and the
# rotation alone.
_NOT_WITH_COLOURS = ("view direction", "SH degree 3, 16 coefficients")
_NO_GRAD = ("radius", "tile rect", "opacity rect")
_SCALES_ROTATION = ("quaternion normalise", "rotation matrix",
                    "squared scales", "3D covariance")


def projection_fwd_ops() -> int:
    return sum(v for k, v in PROJECTION_FWD.items()
               if k not in _NOT_WITH_COLOURS) - 1


def projection_bwd_ops(means_only: bool) -> int:
    skip = _NOT_WITH_COLOURS + _NO_GRAD + (_SCALES_ROTATION if means_only
                                           else ())
    return PROJECTION_BWD_PER_FWD * (sum(
        v for k, v in PROJECTION_FWD.items() if k not in skip) - 1)


# Per pixel of a depth pass's loss, forward: for each of the local and the
# global loss, each of the two maps' patches standardised (mean 1, less
# the mean 1, square 1, sum 1, the map's std 4, the division 2) and the
# margin MSE (difference, abs, square, mask product, sum 5), their weights
# and sum 3; the smoothness (the target's differences and abs 2 x 6 a
# direction, the channel mean and exp 2 x 4, the depth's difference, abs,
# product and sums 2 x 4, the quotient 2). Forward and backward.
DEPTH_LOSS_FWD = 2 * (2 * 10 + 5) + 3
SMOOTHNESS_FWD = 2 * 6 + 2 * 4 + 2 * 4 + 2
# Per Gaussian, the penalties forward: the scales' exp 3, the ratio, its
# sum, the squared max and its sum 4, the opacity's squares, products and
# sums 8
PENALTIES_FWD = 3 + 4 + 8


def depth_loss_ops_per_pixel(smooth: bool) -> int:
    fwd = DEPTH_LOSS_FWD + (SMOOTHNESS_FWD if smooth else 0)
    return (1 + PROJECTION_BWD_PER_FWD) * fwd


def iteration_ops(P: int, n_values: int, n_field_values: int, width: int,
                  height: int, f: dict, works: list, passes: list,
                  smooth: bool = True, C: int = 3) -> int:
    """One iteration over one view: per pass (`passes`, with `works` its
    renders' (`Work`, pairs, tiles) in the same order) the projection,
    forward and, but in the soft pass, backward, the blend forward and
    backward per contributing evaluation and the per-Gaussian sum of the
    pair rows, the pass's losses per pixel, Adam per Gaussian value; in
    the soft and photometric passes the field forward and backward and
    its Adam; in the photometric pass its second evaluation and the
    penalties."""
    field = field_fwd_ops(f) * (1 + PROJECTION_BWD_PER_FWD)
    ops = 0
    for kind, (w, n_pairs, _) in zip(passes, works, strict=True):
        ops += P * (projection_fwd_ops() + SH_MASK)
        if kind != "soft":
            ops += P * projection_bwd_ops(means_only=kind == "hard")
        ops += (blend_ops(C, w.contrib, w.stops)
                + w.contrib * bwd_ops_per_contrib(C) + n_pairs * (C + 8))
        ops += n_values * ADAM
        if kind in ("hard", "soft"):
            ops += width * height * depth_loss_ops_per_pixel(smooth)
        if kind in ("soft", "photo"):
            ops += P * field + n_field_values * ADAM
        if kind == "photo":
            ops += (P * field
                    + P * PENALTIES_FWD * (1 + PROJECTION_BWD_PER_FWD)
                    + width * height * (LOSS_L1 + LOSS_SSIM))
    return ops


def field_values(f: dict) -> int:
    """The field's trained values: the table, the MLPs, the centre."""
    sigma, color = mlp_dims(f)
    mlp = sum(a * b + b for dims in (sigma, color)
              for a, b in zip(dims, dims[1:]))
    return (f["num_levels"] * (1 << f["log2_hashmap_size"])
            * f["level_dim"] + mlp + 3)
