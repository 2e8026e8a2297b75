"""Property test of the tile kernels' per-warp cull box
(`ops/raster.py::cull_box_torch`, the plain version of
`csrc/raster_common.cuh::cull_box`): over random means, conics and
opacities, no pixel of a culled warp rectangle passes the α ≥ 1/255 test.
Needs `hypothesis`; skips where it is not installed."""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from sparse_view_3dgs_pack_tpu_torch.ops import raster  # noqa: E402
from sparse_view_3dgs_pack_tpu_torch.ops.blending import \
    alpha_from_power  # noqa: E402

_F32_EPS = float(np.float32(1.0) / np.float32(255.0))


@st.composite
def _gaussians(draw):
    """One Gaussian's mean, conic and opacity, as float32: ellipses from
    needles to blobs at any angle, near-degenerate conics, indefinite or
    non-positive ones, and NaN or inf entries."""
    f = lambda lo, hi: draw(st.floats(lo, hi, allow_nan=False))
    mx, my = f(-300.0, 1300.0), f(-300.0, 1300.0)
    kind = draw(st.sampled_from(["ellipse", "ellipse", "degenerate",
                                 "indefinite", "nonfinite"]))
    if kind == "ellipse":
        s1, s2 = 10.0 ** f(-1.5, 2.5), 10.0 ** f(-1.5, 2.5)
        th = f(0.0, np.pi)
        co, si = np.cos(th), np.sin(th)
        cxx = co * co * s1 * s1 + si * si * s2 * s2
        cyy = si * si * s1 * s1 + co * co * s2 * s2
        cxy = co * si * (s1 * s1 - s2 * s2)
        det = cxx * cyy - cxy * cxy
        a, b, c = cyy / det, -cxy / det, cxx / det
    elif kind == "degenerate":
        a, c = 10.0 ** f(-4.0, 1.0), 10.0 ** f(-4.0, 1.0)
        b = draw(st.sampled_from([-1.0, 1.0])) * np.sqrt(
            a * c * (1.0 - 10.0 ** f(-8.0, -2.0)))
    elif kind == "indefinite":
        a, c = f(-2.0, 2.0), f(-2.0, 2.0)
        b = np.sqrt(abs(a * c)) * f(1.0, 3.0) * draw(
            st.sampled_from([-1.0, 1.0]))
    else:
        a, b, c = f(0.01, 1.0), f(-0.005, 0.005), f(0.01, 1.0)
        bad = draw(st.sampled_from([np.nan, np.inf, -np.inf]))
        which = draw(st.integers(0, 4))
        if which < 3:
            (a, b, c) = [bad if i == which else v
                         for i, v in enumerate((a, b, c))]
        elif which == 3:
            mx = bad
        else:
            my = bad
    op = draw(st.one_of(
        st.sampled_from([_F32_EPS, _F32_EPS * (1 + 1e-6), _F32_EPS * (1 - 1e-6),
                         _F32_EPS * (1 + 1e-3), _F32_EPS * (1 - 1e-3), 0.99,
                         0.995, 1.0]),
        st.floats(1e-3, 1.0)))
    return np.array([mx, my], np.float32), np.array([a, b, c], np.float32), \
        np.float32(op)


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(_gaussians())
def test_cull_box_never_drops_a_passing_pixel(gauss):
    """No pixel of a warp rectangle that the cull box drops passes the
    kernels' α ≥ 1/255 test in f32 (`alpha_from_power`), nor in float64:
    the warp rectangles of 16×16 and 32×16 tiles at 2 and 4 pixels per
    thread (`raster.warp_rects`: the backward and the training forward, the
    inference forward), tiling windows at the box's edges, corners and
    centre."""
    mean, conic, op = gauss
    box = raster.cull_box_torch(torch.as_tensor(mean)[None],
                                torch.as_tensor(conic)[None],
                                torch.as_tensor(op)[None])[0].double()
    centre = [float(v) if np.isfinite(v) else 0.0 for v in mean]
    edge = [float(v) if torch.isfinite(v) else c
            for v, c in zip(box, (centre[0], centre[0], centre[1],
                                  centre[1]))]
    spots = [(centre[0], centre[1]), (edge[0], centre[1]),
             (edge[1], centre[1]), (centre[0], edge[2]),
             (centre[0], edge[3]), (edge[1], edge[3]), (edge[0], edge[2])]
    wx, wy = 64, 32
    for sx, sy in spots:
        ox = int(np.clip(np.floor(sx / 32.0) * 32 - 32, 0, 65536 - wx))
        oy = int(np.clip(np.floor(sy / 2.0) * 2 - 16, 0, 65536 - wy))
        px = torch.arange(ox, ox + wx, dtype=torch.float32)[None, :]
        py = torch.arange(oy, oy + wy, dtype=torch.float32)[:, None]
        passes = []
        for dt in (torch.float32, torch.float64):
            m = torch.as_tensor(mean, dtype=dt)
            a, b, c = torch.as_tensor(conic, dtype=dt)
            dx, dy = px.to(dt) - m[0], py.to(dt) - m[1]
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            passes.append(alpha_from_power(
                power, torch.as_tensor(op, dtype=dt)) > 0)
        seen = passes[0] | passes[1]                                 # (wy, wx)
        for tile, pixels in ((t, p) for t in ((16, 16), (32, 16))
                             for p in (raster.BWD_PIXELS,
                                       raster.fwd_pixels(False))):
            rx0, rx1, ry0, ry1 = raster.warp_rects(*tile, pixels)[0].tolist()
            rw, rh = rx1 - rx0 + 1, ry1 - ry0 + 1
            x0 = torch.arange(ox, ox + wx, rw, dtype=torch.float64)
            y0 = torch.arange(oy, oy + wy, rh, dtype=torch.float64)
            rect = torch.stack(torch.broadcast_tensors(
                x0[None, :], x0[None, :] + rw - 1, y0[:, None],
                y0[:, None] + rh - 1), -1)                           # (ry, rx, 4)
            dropped = raster.rect_outside(box, rect)
            hit = seen.reshape(wy // rh, rh, wx // rw, rw).any(3).any(1)
            assert not bool((dropped & hit).any()), (mean, conic, op, rw)
