"""Port parity for the FSGS slice: the depth losses (value and gradient),
the depth warp, the pseudo poses and `sample_np`, the precomputed and
MiDaS depth providers, FSGS's densify masks,
distance split and proximity densification, the three FSGS steps
(`fsgs_step`, `fsgs_warped_pseudo_step`, `fsgs_pseudo_step`), a short
FSGS run of the train CLI in which every FSGS mechanism fires, both
packages' whole `train_fsgs` loops held together event by event across
densification, and the few-shot arms' command lines against the JAX
script's.

Inputs are made with numpy from a seed and handed to both packages. The
JAX steps run their XLA tiled path (`use_pallas=False`). Their gradients
are read from the first Adam moment: from zero moments one step leaves
m = (1 - β1)·g on both sides, whatever the learning rate."""

import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.depth import estimator as jax_estimator
from sparse_view_3dgs_pack_tpu.depth import warp as jax_warp
from sparse_view_3dgs_pack_tpu.losses import depth as jax_depth
from sparse_view_3dgs_pack_tpu.losses import photometric as jax_photo
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.ops.rasterize_tiles import RasterConfig
from sparse_view_3dgs_pack_tpu.train import densify as jax_densify
from sparse_view_3dgs_pack_tpu.train import fsgs_loop as jax_fsgs
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train import step as jax_step
from sparse_view_3dgs_pack_tpu.utils import pose_utils as jax_pose
from sparse_view_3dgs_pack_tpu.utils import stepfun as jax_stepfun
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.depth import estimator, warp
from sparse_view_3dgs_pack_tpu_torch.losses import depth, photometric
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.train import densify, fsgs_loop, optim
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank
from sparse_view_3dgs_pack_tpu_torch.utils import (image_io, pose_utils,
                                                   stepfun)
from torch_port import REPO, subprocess_env

PARAMS = gm.PARAM_NAMES
W, H = 48, 32
RASTER = RasterConfig(max_pairs=1 << 15, max_per_tile=1024, tile_batch=16)
BETA1 = 0.9
# losses: float32 sums of a few thousand products in another order
LOSS_RTOL = 1e-5
# gradients, of each group's largest: the JAX path differentiates its blend
# scan, the port runs the analytic backward (test_torch_train.py holds the
# lgdwt step to 1e-4; here the worst seen is 2.4e-5, one rotation entry
# with a confidence vector)
GRAD_TOL = 5e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ----------------------------------------------------------------- losses
def _depth_inputs(seed=0, h=40, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rendered = (2.0 + np.sin(xx / 7.0) + 0.3 * rng.random((h, w))).astype(
        np.float32)
    prior = (255.0 * (1.0 / rendered) / (1.0 / rendered).max()
             + 5 * rng.random((h, w))).astype(np.float32)
    mask = rng.random((h, w)) > 0.3
    return rendered, prior, mask


_LOSSES = {
    "pearson": (lambda m: m.pearson_corrcoef, False),
    "pearson_masked": (lambda m: m.pearson_corrcoef_masked, True),
    "fsgs_depth": (lambda m: m.fsgs_depth_loss, False),
    "pseudo_depth": (lambda m: m.pseudo_depth_loss, False),
    "warped_pseudo_depth": (lambda m: m.warped_pseudo_depth_loss, True),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_depth_losses_match_jax(name):
    """Value within LOSS_RTOL, gradient w.r.t. the rendered depth within
    GRAD_TOL of the largest."""
    pick, masked = _LOSSES[name]
    rendered, prior, mask = _depth_inputs()
    extra = (mask,) if masked else ()
    jfn = pick(jax_depth)
    want, jg = jax.value_and_grad(
        lambda r: jfn(r, jnp.asarray(prior),
                      *(jnp.asarray(e) for e in extra)))(
            jnp.asarray(rendered))
    r = torch.tensor(rendered, requires_grad=True)
    got = pick(depth)(r, torch.tensor(prior),
                      *(torch.tensor(e) for e in extra))
    got.backward()
    assert abs(float(got.detach()) - float(want)) \
        <= LOSS_RTOL * abs(float(want))
    jg = np.asarray(jg)
    np.testing.assert_allclose(r.grad.numpy(), jg,
                               atol=GRAD_TOL * np.abs(jg).max(), rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_l1_loss_mask_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    a, b = (rng.random((H, W, 3)).astype(np.float32) for _ in range(2))
    m = (rng.random((H, W, 1)) > 0.4).astype(np.float32) if with_mask \
        else None
    want = jax_photo.l1_loss_mask(jnp.asarray(a), jnp.asarray(b),
                                  None if m is None else jnp.asarray(m))
    got = photometric.l1_loss_mask(torch.tensor(a), torch.tensor(b),
                                   None if m is None else torch.tensor(m))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * float(want)


# -------------------------------------------------------------- depth warp
def _warp_cams():
    """Two orbit cameras 20° apart and a smooth depth map of the first."""
    cams = testing.make_orbit_cameras(2, radius=3.0, width=W, height_px=H)
    dst = testing.make_orbit_cameras(1, radius=3.2, width=W, height_px=H,
                                     phase=math.radians(20))[0]
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    z = (3.0 + 0.4 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
         + 0.05 * rng.random((H, W))).astype(np.float32)
    valid = rng.random((H, W)) > 0.1
    return cams[0].params(), dst.params(), z, valid


# splat pixels within f32 rounding of .5 may land on the other side
MAX_FLIPPED = 0.01


def test_warp_depth_matches_jax():
    """Valid masks equal but for at most MAX_FLIPPED of the pixels; z
    within 1e-5 relative where both are valid, but for that same share
    (a flipped splat changes which source pixel wins the z-buffer)."""
    src, dst, z, valid = _warp_cams()
    jz, jv = jax_warp.warp_depth(jnp.asarray(z), jnp.asarray(valid),
                                 jax.tree.map(jnp.asarray, src),
                                 jax.tree.map(jnp.asarray, dst), W, H)
    tz, tv = warp.warp_depth(torch.tensor(z), torch.tensor(valid), src, dst,
                             W, H)
    jz, jv, tz, tv = np.asarray(jz), np.asarray(jv), tz.numpy(), tv.numpy()
    assert 0.3 < jv.mean() < 1.0
    assert (jv != tv).mean() <= MAX_FLIPPED
    both = jv & tv
    off = np.abs(tz - jz) > 1e-5 * np.abs(jz)
    assert (off & both).sum() <= MAX_FLIPPED * both.size
    assert (tz[~tv] == 0).all()


def test_metric_depth_from_prior_matches_jax():
    rendered, prior, _ = _depth_inputs(3, H, W)
    inv = (1.0 / rendered).astype(np.float32)
    alpha = np.random.default_rng(4).random((H, W)).astype(np.float32)
    jz, jv = jax_warp.metric_depth_from_prior(
        jnp.asarray(prior), jnp.asarray(inv), jnp.asarray(alpha))
    tz, tv = warp.metric_depth_from_prior(
        torch.tensor(prior), torch.tensor(inv), torch.tensor(alpha))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5)
    a, b = warp.fit_inv_affine(torch.tensor(prior), torch.tensor(inv),
                               torch.tensor(alpha > 0.5))
    ja, jb = jax_warp.fit_inv_affine(jnp.asarray(prior), jnp.asarray(inv),
                                     jnp.asarray(alpha > 0.5))
    assert float(a) == pytest.approx(float(ja), rel=1e-5)
    # b = mean(inv) - a·mean(prior) cancels: held to 1e-5 of the scale of
    # the inverse depths it offsets
    assert float(b) == pytest.approx(float(jb), abs=1e-5 * inv.max())


# -------------------------------------------------- poses, sample_np
_POSES = {
    "llff": lambda m, c: m.generate_random_poses_llff(c, n_poses=20),
    "360": lambda m, c: m.generate_random_poses_360(c, n_poses=20),
    "spiral": lambda m, c: m.generate_spiral_path(c, n_frames=12),
    "ellipse": lambda m, c: m.generate_ellipse_path(c, n_frames=12),
}


@pytest.mark.parametrize("kind", sorted(_POSES))
def test_pose_paths_bitwise_equal_jax(kind):
    port_cams = testing.make_orbit_cameras(5, radius=3.0, width=W,
                                           height_px=H)
    jax_cams = jax_testing.make_orbit_cameras(5, radius=3.0, width=W,
                                              height_px=H)
    got = _POSES[kind](pose_utils, port_cams)
    want = _POSES[kind](jax_pose, jax_cams)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for x, y in zip(a.params(), b.params()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)


@pytest.mark.parametrize("rand", [False, True])
def test_sample_np_bitwise_equal_jax(rand):
    rng = np.random.default_rng(5)
    t = np.sort(rng.random(30)) * 4
    logits = rng.normal(size=29)
    np.random.seed(7)
    got = stepfun.sample_np(rand, t, logits, 17)
    np.random.seed(7)
    want = jax_stepfun.sample_np(rand, t, logits, 17)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- depth providers
def test_resize_matches_cv2_inter_linear():
    """`resize_bilinear` is cv2.resize's INTER_LINEAR (half-pixel centres),
    up and down, within 1e-5 of the map's range (both interpolate in
    float32; cv2 rounds its source coordinates and weights its own way)."""
    cv2 = pytest.importorskip("cv2")
    d = np.random.default_rng(6).random((37, 53)).astype(np.float32) * 255
    for w, h in ((80, 61), (29, 18), (53, 37)):
        np.testing.assert_allclose(estimator.resize_bilinear(d, w, h),
                                   cv2.resize(d, (w, h)), rtol=0,
                                   atol=1e-5 * 255)


@pytest.mark.parametrize("ext", [".npy", ".png"])
def test_precomputed_depth_matches_jax(tmp_path, ext):
    """The precomputed provider reads the same map as the JAX one, resized
    to the camera (within 1e-5 of the 0–255 range: cv2 against
    F.interpolate)."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    d = (rng.random((20, 30)) * 255).astype(np.uint8)
    ddir = tmp_path / "depth_maps"
    os.makedirs(ddir)
    if ext == ".npy":
        np.save(ddir / "r_000.npy", d.astype(np.float32))
    else:
        image_io.write_png(str(ddir / "r_000.png"), d)
    cam = testing.make_orbit_cameras(1, width=W, height_px=H)[0]
    got = estimator.get_depth_estimator("precomputed", str(tmp_path))
    want = jax_estimator.get_depth_estimator("precomputed", str(tmp_path))
    assert got.available and not got.can_estimate
    a, b = got.depth_for_camera(cam), want.depth_for_camera(cam)
    assert a.shape == (H, W) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * 255)
    cam.image_name = "missing.png"
    assert got.depth_for_camera(cam) is None
    assert isinstance(estimator.get_depth_estimator("none", str(tmp_path)),
                      estimator.NoDepth)


_HUBCONF = """
import torch
class _Stub(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
    def forward(self, x):
        return x.mean(1) * self.w
def DPT_Hybrid(pretrained=True):
    return _Stub()
"""


def test_midas_loads_only_from_the_hub_cache(tmp_path):
    """`midas` loads the cached repository (`source="local"`) once the
    cache also holds its weights; without them it raises and `auto` falls
    back to no priors. A stub hubconf stands in for MiDaS."""
    hub = tmp_path / "hub"
    repo = hub / estimator.MIDAS_REPO
    os.makedirs(repo)
    (repo / "hubconf.py").write_text(_HUBCONF)
    with pytest.raises(RuntimeError, match="nothing is downloaded"):
        estimator.MidasDepth(str(hub))
    os.makedirs(hub / "checkpoints")
    (hub / "checkpoints" / "dpt_hybrid_384.pt").write_bytes(b"")
    est = estimator.MidasDepth(str(hub))
    assert est.available and est.can_estimate
    img = np.random.default_rng(8).random((H, W, 3)).astype(np.float32)
    out = est.estimate(img)
    assert tuple(out.shape) == (H, W) and torch.isfinite(out).all()
    with pytest.warns(UserWarning, match="depth priors disabled"):
        none = estimator.get_depth_estimator("auto", str(tmp_path / "x"))
    assert isinstance(none, estimator.NoDepth)


# ------------------------------------------------------------ FSGS state
def _fsgs_fixture(n=200, seed=3, with_depth=True):
    """A JAX state of Gaussians before 3 orbit cameras with random targets
    and DPT-style disparity priors, its port twin, and both banks."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=3, sh_degree=1,
                                   capacity=256)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["features_rest"][:n] = rng.normal(size=(n, 3, 3)) * 0.2
    params["opacity"][:n, 0] = rng.uniform(-1.0, 2.5, n)
    params["scaling"][:n] = np.log(rng.uniform(0.04, 0.14, (n, 3)))
    params["rotation"][:n] = rng.normal(size=(n, 4))
    state = state._replace(params={k: jnp.asarray(v)
                                   for k, v in params.items()})
    cams = testing.make_orbit_cameras(3, radius=3.0, width=W, height_px=H)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i, c in enumerate(cams):
        c.image = rng.random((H, W, 3)).astype(np.float32)
        c.alpha_mask = (rng.random((H, W)) > 0.1).astype(np.float32)
        if with_depth:
            c.invdepthmap = (255.0 * (0.5 + 0.5 * np.sin(xx / (6.0 + i)
                                                          + yy / 9.0))
                             ).astype(np.float32)
            c.depth_mask = np.ones((H, W), np.float32)
            c.depth_reliable = True
    jbank = jax_step.CameraBank.from_cameras(cams)
    tbank = CameraBank.from_cameras(cams, 3, "cpu")
    return state, cams, jbank, tbank


def _cfgs(use_confidence=False):
    return (jax_fsgs.FSGSConfig(width=W, height=H, sh_degree=1,
                                raster=RASTER, use_pallas=False,
                                use_confidence=use_confidence),
            fsgs_loop.FSGSConfig(width=W, height=H, sh_degree=1,
                                 use_confidence=use_confidence))


def _assert_grads_from_moments(adam, jadam, n, zero=()):
    """Each group's m after one step from zero: (1 - β1)·g; the groups in
    `zero` get no gradient on either side."""
    for k in PARAMS:
        want = np.asarray(jadam.m[k])[:n] / (1 - BETA1)
        got = _np(adam.m[k]) / (1 - BETA1)
        if k in zero:
            assert not want.any() and not got.any(), k
            continue
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got, want,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("conf", ["none", "vector"])
def test_fsgs_step_matches_jax(conf):
    """One FSGS step at 48×32 with 200 Gaussians (SH 1, the depth prior on,
    the alpha mask partial): the loss, every gradient (from the first Adam
    moment) within GRAD_TOL of the largest, and the densification
    statistics; with a non-trivial confidence vector too."""
    state, _, jbank, tbank = _fsgs_fixture()
    n = int(state.n_alive)
    use = conf == "vector"
    jcfg, tcfg = _cfgs(use)
    c = np.random.default_rng(9).uniform(0.2, 1.0, 256).astype(np.float32)
    lrs = {k: 1e-3 for k in PARAMS}
    jadam = jax_optim.init_adam(state.params)
    jstate, jadam, jm = jax_fsgs.fsgs_step(
        state, jadam, jbank, jnp.asarray(1, jnp.int32),
        {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
        jnp.asarray(0.5, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.zeros(3), jcfg, confidence=jnp.asarray(c) if use else None)
    port = gm.from_jax_state(state, device="cpu")
    adam = optim.init_adam(port.model.params())
    m = fsgs_loop.fsgs_step(port.model, adam, tbank, 1, lrs, 0.5, 1,
                            torch.zeros(3), tcfg,
                            torch.tensor(c[:n]) if use else None)
    for key in ("loss", "l1", "depth"):
        assert abs(float(m[key]) - float(jm[key])) \
            <= LOSS_RTOL * abs(float(jm[key])), key
    assert float(jm["depth"]) > 0.05          # the prior is in the loss
    _assert_grads_from_moments(adam, jadam, n)
    np.testing.assert_allclose(_np(port.model.xyz_gradient_accum),
                               np.asarray(jstate.xyz_gradient_accum)[:n],
                               rtol=1e-4, atol=1e-9)
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(_np(getattr(port.model, k)),
                                      np.asarray(getattr(jstate, k))[:n])


def test_fsgs_warped_pseudo_step_matches_jax():
    """The warped pseudo step from view 0's prior into a pseudo camera:
    loss within LOSS_RTOL, gradients from the first Adam moment within
    GRAD_TOL of the largest (the colours get none)."""
    state, cams, jbank, tbank = _fsgs_fixture()
    n = int(state.n_alive)
    jcfg, tcfg = _cfgs()
    dst = testing.make_orbit_cameras(1, radius=3.1, width=W, height_px=H,
                                     phase=0.3)[0].params()
    lrs = {k: 1e-3 for k in PARAMS}
    jadam = jax_optim.init_adam(state.params)
    _, jadam, jloss = jax_fsgs.fsgs_warped_pseudo_step(
        state, jadam, jbank.camera(jnp.asarray(0, jnp.int32)),
        jbank.invdepth[0], jax.tree.map(jnp.asarray, dst),
        {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
        jnp.asarray(0.7, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.zeros(3), jcfg)
    port = gm.from_jax_state(state, device="cpu")
    adam = optim.init_adam(port.model.params())
    loss, coverage, applied = fsgs_loop.fsgs_warped_pseudo_step(
        port.model, adam, tbank.camera(0), tbank.invdepth[0], dst, lrs, 0.7,
        1, torch.zeros(3), tcfg)
    assert applied and coverage > fsgs_loop.MIN_COVERAGE
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_grads_from_moments(adam, jadam, n,
                               zero=("features_dc", "features_rest"))


class _StubEstimator(estimator.DepthEstimator):
    """A depth network stand-in that scores any render: 255 times a
    smooth function of the image."""
    available = True
    can_estimate = True

    def estimate(self, image_hwc):
        img = torch.as_tensor(image_hwc)
        return 255.0 * (0.2 + img.mean(-1)) / (1.2 + img[..., 0])


def test_fsgs_pseudo_step_matches_jax():
    """The pseudo step against a stub estimator's reading of the pseudo
    render (the same array to both): loss, and gradients from the first
    Adam moment within GRAD_TOL of the largest."""
    state, _, _, _ = _fsgs_fixture()
    n = int(state.n_alive)
    jcfg, tcfg = _cfgs()
    pcam = testing.make_orbit_cameras(1, radius=3.2, width=W, height_px=H,
                                      phase=0.2)[0].params()
    port = gm.from_jax_state(state, device="cpu")
    img, _ = fsgs_loop.fsgs_render_pseudo(port.model, pcam, 1,
                                          torch.zeros(3), tcfg)
    midas = _StubEstimator().estimate(img)
    lrs = {k: 1e-3 for k in PARAMS}
    jadam = jax_optim.init_adam(state.params)
    _, jadam, jloss = jax_fsgs.fsgs_pseudo_step(
        state, jadam, jax.tree.map(jnp.asarray, pcam),
        jnp.asarray(midas.numpy()),
        {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1, jnp.int32),
        jnp.zeros(3), jcfg)
    adam = optim.init_adam(port.model.params())
    loss, applied = fsgs_loop.fsgs_pseudo_step(port.model, adam, pcam, midas,
                                               lrs, 1.0, 1, torch.zeros(3),
                                               tcfg)
    assert applied
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    # a depth-only loss: the colours get no gradient
    _assert_grads_from_moments(adam, jadam, n,
                               zero=("features_dc", "features_rest"))


# ---------------------------------------------------------- densification
def _exact_knn3(points, window=32, k=3, passes=3, valid=None):
    """Exact, valid-aware 3-NN for the JAX side (its own `knn3` is a
    windowed approximation), nearest first, ties to the lower index;
    traceable, as the JAX callers are jitted."""
    d = points[:, None, :] - points[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = jnp.where(jnp.eye(points.shape[0], dtype=bool), jnp.inf, d2)
    if valid is not None:
        d2 = jnp.where(valid[None, :], d2, jnp.inf)
    idx = jnp.argsort(d2, axis=1, stable=True)[:, :k]
    top = jnp.take_along_axis(d2, idx, 1)
    return (top[:, 0] + top[:, 1] + top[:, 2]) / 3.0, idx.astype(jnp.int32)


def _outlier_state(seed=11):
    """A JAX state with statistics, Adam moments, and a few far Gaussians
    with large scales: the proximity and distance masks select them."""
    rng = np.random.default_rng(seed)
    n, cap = 90, 512
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:6] = rng.normal(size=(6, 3)) * 12.0
    state = jax_gm.create_from_pcd(pts, rng.random((n, 3)).astype(np.float32),
                                   n_images=2, sh_degree=1, capacity=cap)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["scaling"][:n] = np.log(rng.uniform(0.02, 0.08, (n, 3)))
    params["scaling"][:6] = np.log(3.0)
    params["opacity"][:n, 0] = rng.uniform(-6.0, 2.0, n)
    params["rotation"][:n] = rng.normal(size=(n, 4))
    accum = np.zeros(cap, np.float32)
    denom = np.zeros(cap, np.float32)
    accum[:n] = rng.uniform(0, 4e-4, n) * 3
    denom[:n] = rng.integers(0, 4, n)
    state = state._replace(
        params={k: jnp.asarray(v) for k, v in params.items()},
        xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom))
    adam = jax_optim.init_adam(state.params)
    adam = adam._replace(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in adam.m.items()},
        v={k: jnp.asarray(rng.random(v.shape).astype(np.float32))
           for k, v in adam.v.items()},
        step=jnp.asarray(5, jnp.int32))
    return state, adam


EXTENT, DIST_THRES = 1.0, 10.0


def _assert_state(model, state, rtol=1e-6, atol=1e-7):
    n = int(state.n_alive)
    assert model.num_points == n
    for k in PARAMS:
        np.testing.assert_allclose(_np(getattr(model, k)),
                                   np.asarray(state.params[k])[:n],
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in gm.STAT_NAMES:
        np.testing.assert_array_equal(_np(getattr(model, k)),
                                      np.asarray(getattr(state, k))[:n])


def _assert_adam(adam, jadam, n):
    assert adam.step == int(jadam.step)
    for k in PARAMS:
        for name in ("m", "v"):
            np.testing.assert_array_equal(
                _np(getattr(adam, name)[k]),
                np.asarray(getattr(jadam, name)[k])[:n],
                err_msg=f"{name}[{k}]")


def test_fsgs_densify_masks_and_proximity_match_jax(monkeypatch):
    """The masks and neighbours (the JAX module's `knn3` replaced by an
    exact search in this test), then `proximity_densify` on them: the
    appended midpoints, scales, opacities, identity rotations and zero SH,
    index by index; zero Adam moments on the new rows; statistics
    cleared."""
    monkeypatch.setattr(jax_fsgs, "knn3", _exact_knn3)
    state, jadam = _outlier_state()
    port = gm.from_jax_state(state, jadam, device="cpu")
    n = int(state.n_alive)
    jprox, jidx, jsplit = jax_fsgs.fsgs_densify_masks(
        state, jnp.asarray(EXTENT), jnp.asarray(DIST_THRES))
    prox, idx, split = fsgs_loop.fsgs_densify_masks(port.model, EXTENT,
                                                    DIST_THRES)
    np.testing.assert_array_equal(prox.numpy(), np.asarray(jprox)[:n])
    np.testing.assert_array_equal(split.numpy(), np.asarray(jsplit)[:n])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx)[:n])
    assert 0 < int(prox.sum()) and 0 < int(split.sum())
    res = jax_densify.proximity_densify(state, jadam, jidx, jprox)
    appended = densify.proximity_densify(port.model, port.adam, idx, prox)
    assert appended == int(res.appended) == 3 * int(prox.sum())
    _assert_state(port.model, res.state)
    _assert_adam(port.adam, res.opt_state, int(res.state.n_alive))
    new = port.model.rotation[n:].detach()
    assert (new[:, 0] == 1).all() and (new[:, 1:] == 0).all()


def test_densify_and_prune_extra_split_matches_jax(monkeypatch):
    """`densify_and_prune(extra_split_mask=...)`: the distance-selected
    Gaussians split (and are not cloned), with the JAX draw handed over."""
    monkeypatch.setattr(jax_fsgs, "knn3", _exact_knn3)
    state, jadam = _outlier_state(seed=12)
    port = gm.from_jax_state(state, jadam, device="cpu")
    n, cap = int(state.n_alive), state.capacity
    _, _, jsplit = jax_fsgs.fsgs_densify_masks(
        state, jnp.asarray(EXTENT), jnp.asarray(DIST_THRES))
    key = jax.random.PRNGKey(3)
    res = jax_densify.densify_and_prune(
        state, jadam, key, 0.0002, 0.005, EXTENT, max_screen_size=0,
        percent_dense=0.01, extra_split_mask=jsplit)
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (cap, 3)))[:n])
    out = densify.densify_and_prune(
        port.model, port.adam, 0.0002, 0.005, EXTENT, percent_dense=0.01,
        noise=torch.tensor(np.stack(draws)),
        extra_split_mask=torch.tensor(np.asarray(jsplit)[:n]))
    assert int(res.appended) == int(res.requested)
    assert out.split >= int(np.asarray(jsplit).sum()) > 0
    _assert_state(port.model, res.state, rtol=1e-6)
    _assert_adam(port.adam, res.opt_state, int(res.state.n_alive))


# -------------------------------------------------------------- the loop
def test_train_fsgs_runs_the_estimator_branch(tmp_path, monkeypatch):
    """A depth provider that scores novel renders sends the loop down the
    reference's pseudo step (not the warp)."""
    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=32, n_gauss=200,
                                            n_dense=150, n_sparse=40)
    monkeypatch.setattr(fsgs_loop, "get_depth_estimator",
                        lambda kind, path: _StubEstimator())
    from argparse import Namespace
    from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                        PipelineParams)
    from argparse import ArgumentParser
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "fsgs"), PipelineParams(parser)
    args = parser.parse_args(["--iterations", "12", "--start_sample_pseudo",
                              "2", "--sample_pseudo_interval", "3",
                              "--densify_until_iter", "0"])
    out = tmp_path / "out"
    os.makedirs(out)
    dataset = Namespace(source_path=scene, model_path=str(out), sh_degree=1,
                        images="images", depths="", eval=True,
                        train_test_exp=False, n_views=3,
                        point_cloud_type="dense", resolution=-1,
                        white_background=False, data_device="cpu")
    pipe = pp.extract(args)
    pipe.debug_from = -1
    run = Namespace(save_iterations=[12], test_iterations=[],
                    depth_estimator="auto")
    counts = fsgs_loop.train_fsgs(dataset, op.extract(args), pipe, run,
                                  torch.device("cpu"))
    assert counts["pseudo_steps"] == 4 and counts["warped_steps"] == 0
    assert os.path.exists(out / "point_cloud" / "iteration_12" /
                          "point_cloud.ply")


_PORT_TRAIN = """
import runpy, sys
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("sparse_view_3dgs_pack_tpu_torch.train", run_name="__main__")
assert "jax" not in sys.modules, "the port imported jax"
"""


@pytest.mark.timeout(600)
def test_fsgs_train_cli_fires_every_mechanism(tmp_path):
    """`--method fsgs` on a 48-px forward-facing scene with a few stray
    points in its dense init, 40 iterations: the warped pseudo step runs
    (and passes its coverage test), the distance split and the proximity
    append fire, the output tree is the JAX CLI's, and the render and
    metrics CLIs read it (results.json with the LPIPS keys)."""
    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=48, n_gauss=400,
                                            n_dense=300, n_sparse=60,
                                            n_outliers=6)
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_TRAIN, "-s", scene, "-m", out,
         "--method", "fsgs", "--device", "cpu", "--eval", "--n_views", "3",
         "--point_cloud_type", "dense", "--depth_estimator", "precomputed",
         "--iterations", "40", "--densify_from_iter", "5",
         "--densification_interval", "10", "--densify_until_iter", "12",
         "--start_sample_pseudo", "12", "--end_sample_pseudo", "38",
         "--sample_pseudo_interval", "5", "--proximity_until_iter", "40",
         "--use_confidence", "--test_iterations", "40", "--disable_viewer"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [l for l in proc.stdout.splitlines() if "FSGS counts:" in l][0]
    counts = {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", line)}
    assert counts["warped_steps"] == 5 and counts["warped_applied"] > 0
    assert counts["distance_splits"] > 0 and counts["proximity_appended"] > 0
    assert counts["peak_gaussians"] > 306
    for name in ("cfg_args", "input.ply", "cameras.json",
                 "point_cloud/iteration_40/point_cloud.ply"):
        assert os.path.exists(os.path.join(out, name)), name
    for mod, extra in (("render", ["--skip_train"]), ("metrics", [])):
        proc = subprocess.run(
            [sys.executable, "-m", f"sparse_view_3dgs_pack_tpu_torch.{mod}",
             "-m", out, "--device", "cpu", *extra], cwd=REPO,
            env=subprocess_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)["ours_40"]
    assert {"SSIM", "PSNR", "LPIPS_backend"} <= set(res)
    assert ("LPIPS" in res) or ("LPIPS_proxy" in res)


def test_fewshot_arm_commands():
    """The few-shot CLI's arms run the port's train → render → metrics
    with the JAX script's flags (`scripts/fsgs_fewshot_bench.py:224-247`):
    the grad threshold scaled to the image size, evals every tenth of the
    run."""
    from sparse_view_3dgs_pack_tpu_torch import fewshot
    train, render, metrics = fewshot.arm_commands(
        "fsgs_dense", "scene", "out", 10_000, 400, "cuda")
    assert train[1:3] == ["-m", "sparse_view_3dgs_pack_tpu_torch.train"]
    flags = " ".join(train)
    assert "--method fsgs" in flags and "--n_views 3" in flags
    assert "--point_cloud_type dense --depth_estimator precomputed" in flags
    assert "--densify_grad_threshold 0.0004" in flags
    assert "--test_iterations " + " ".join(
        str(i) for i in range(1000, 10_001, 1000)) in flags
    assert render[2:] == ["sparse_view_3dgs_pack_tpu_torch.render", "-m",
                          "out", "--skip_train", "--device", "cuda"]
    assert metrics[2] == "sparse_view_3dgs_pack_tpu_torch.metrics"
    assert "--point_cloud_type sparse" in " ".join(fewshot.arm_commands(
        "3dgs", "scene", "out", 40, 48, "cpu")[0])


# ------------------------------------------- the whole loop, event by event
# a differing densify decision is excused when the two sides' float64
# values of its statistic lie on either side of the threshold and differ by
# at most this share of it: the states drift apart by float32 rounding
# compounded over the steps between events (≤ 0.34% of a group's largest
# entry by the fourth event, measured)
FLIP_REL = 5e-3
# end-of-run test PSNR, port against JAX
LOOP_PSNR_TOL = 0.02
_LOOP_FLAGS = ["--iterations", "120", "--densify_from_iter", "20",
               "--densification_interval", "20", "--densify_until_iter",
               "120", "--proximity_until_iter", "80",
               "--start_sample_pseudo", "60", "--end_sample_pseudo", "110",
               "--sample_pseudo_interval", "5", "--densify_grad_threshold",
               "0.001", "--percent_dense", "0.1"]


def _mean3_d2(xyz):
    """Exact mean squared distance to the 3 nearest other points, float64."""
    x = np.asarray(xyz, np.float64)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :3].mean(1)


def _decisions(accum, denom, scaling, opacity, xyz, extra, opt, extent):
    """One side's densify decisions replayed from its float32 state: the
    clone, split and prune masks as the event takes them (the appended
    rows inherit their source's opacity), the counts, and each statistic
    in float64 with its threshold, for judging a flip."""
    accum, denom = np.asarray(accum), np.asarray(denom)
    g32 = np.where(denom > 0, accum / np.maximum(denom, np.float32(1)),
                   np.float32(0))
    ms32 = np.exp(np.asarray(scaling)).max(-1)
    op32 = 1 / (1 + np.exp(-np.asarray(opacity)[:, 0]))
    sel = g32 >= np.float32(opt.densify_grad_threshold)
    split = (sel & (ms32 > opt.percent_dense * extent)) | extra
    clone = sel & ~split
    low = op32 < 0.005
    pruned = int((low | split).sum() + (low & clone).sum()
                 + 2 * (low & split).sum())
    g64 = np.where(denom > 0, accum.astype(np.float64)
                   / np.maximum(denom, 1), 0.0)
    ms64 = np.exp(np.asarray(scaling, np.float64)).max(-1)
    op64 = 1 / (1 + np.exp(-np.asarray(opacity, np.float64)[:, 0]))
    stats = {"grad": (g64, opt.densify_grad_threshold),
             "scale": (ms64, opt.percent_dense * extent),
             "opacity": (op64, 0.005), "big": (ms64, extent),
             "dist": (_mean3_d2(xyz), opt.dist_thres * extent)}
    return dict(clone=clone, split=split, low=low, extra=extra,
                cloned=int(clone.sum()), n_split=int(split.sum()),
                pruned=pruned, stats=stats)


def _judge_flips(port, jax_, what):
    """Every Gaussian whose decisions differ: one of its statistics must
    straddle its threshold within FLIP_REL (float64 on both sides).
    Returns the number of such Gaussians."""
    differ = np.zeros(len(port["clone"]), bool)
    for k in ("clone", "split", "low", "extra"):
        differ |= port[k] != jax_[k]
    for i in np.nonzero(differ)[0]:
        ok = []
        for name, (vp, thr) in port["stats"].items():
            vj = jax_["stats"][name][0][i]
            ok.append((min(vp[i], vj) <= thr <= max(vp[i], vj))
                      and abs(vp[i] - vj) <= FLIP_REL * thr)
        assert any(ok), (f"{what}: Gaussian {i} decides otherwise with no "
                         f"statistic at a threshold: " + ", ".join(
                             f"{n} {port['stats'][n][0][i]!r} / "
                             f"{jax_['stats'][n][0][i]!r} vs {t!r}"
                             for n, (_, t) in port["stats"].items()))
    return int(differ.sum())


@pytest.mark.timeout(600)
def test_train_fsgs_loop_matches_jax_across_densify_events(tmp_path,
                                                            monkeypatch):
    """Both packages' `train_fsgs` on one 32-px few-shot scene with a dense
    init, disparity priors and 6 stray points, 120 iterations: densify
    events at 40, 60, 80 and 100 (proximity at the first two), an opacity
    reset at 61, warped pseudo steps from 65. Python's `random` is seeded
    alike, the port starts from JAX's initial state, takes JAX's split
    draws, and JAX's windowed 3-NN is replaced by the exact search. At
    every event the Gaussian count, clones, splits, distance splits,
    prunes and proximity appends must be equal, or each Gaussian deciding
    otherwise must have a statistic straddling its threshold within
    FLIP_REL (then the port restarts from JAX's state after the event);
    the test PSNR at the end agrees within LOOP_PSNR_TOL."""
    import copy
    import random
    from argparse import ArgumentParser, Namespace

    from sparse_view_3dgs_pack_tpu.train import loop as jax_loop
    from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                        PipelineParams)

    scene = testing.write_llff_colmap_scene(
        str(tmp_path / "scene"), size=32, n_gauss=400, n_dense=300,
        n_sparse=60, n_outliers=6, device="cpu")
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "fsgs"), PipelineParams(parser)
    args = parser.parse_args(_LOOP_FLAGS)
    opt, pipe = op.extract(args), pp.extract(args)
    pipe.debug_from = -1
    jpipe = copy.copy(pipe)   # small XLA pair buffers on the JAX side
    jpipe.max_pairs, jpipe.max_per_tile, jpipe.tile_batch = 1 << 13, 1024, 16

    def dataset(name):
        os.makedirs(tmp_path / name)
        return Namespace(source_path=scene, model_path=str(tmp_path / name),
                         sh_degree=3, images="images", depths="", eval=True,
                         train_test_exp=False, n_views=3,
                         point_cloud_type="dense", resolution=-1,
                         white_background=False, data_device="cpu")
    run = Namespace(save_iterations=[], test_iterations=[],
                    depth_estimator="precomputed")

    # ---- JAX, recording each event's states
    monkeypatch.setenv("GS_SPECULATIVE_COMPILE", "0")
    monkeypatch.setattr(jax_fsgs, "knn3", _exact_knn3)
    jev, jeval, init = [], [], []
    jax_dp, jax_prox = jax_fsgs.densify_and_prune, jax_fsgs.proximity_densify
    jax_eval = jax_loop.evaluate_cameras

    def j_densify(state, adam, key, *a, **kw):
        res = jax_dp(state, adam, key, *a, **kw)
        jev.append(dict(pre=state, key=key, extra=kw["extra_split_mask"],
                        res=res, post=(res.state, res.opt_state), prox=0))
        return res

    def j_prox(state, adam, idx, mask):
        res = jax_prox(state, adam, idx, mask)
        jev[-1].update(post=(res.state, res.opt_state),
                       prox=int(res.appended))
        return res

    class JaxScene(jax_fsgs.Scene):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            init.append(self.gaussians)

    monkeypatch.setattr(jax_fsgs, "densify_and_prune", j_densify)
    monkeypatch.setattr(jax_fsgs, "proximity_densify", j_prox)
    monkeypatch.setattr(jax_fsgs, "Scene", JaxScene)
    monkeypatch.setattr(jax_loop, "evaluate_cameras",
                        lambda *a, **kw: jeval.append(jax_eval(*a, **kw))
                        or jeval[-1])
    random.seed(0)
    np.random.seed(0)
    jax_fsgs.train_fsgs(dataset("jax"), opt, jpipe, run)

    # ---- the port, held to each event
    rows, flips = [], []
    port_dp = fsgs_loop.densify_and_prune
    port_prox = fsgs_loop.proximity_densify
    port_eval = fsgs_loop.evaluate_cameras
    pending = []

    def restart(model, adam, e):
        b = gm.from_jax_state(*e["post"], device="cpu")
        model.set_rows({k: getattr(b.model, k).detach()
                        for k in model.row_names()})
        adam.m.update(b.adam.m)
        adam.v.update(b.adam.v)
        assert adam.step == b.adam.step

    def p_densify(model, adam, max_grad, min_opacity, extent, **kw):
        e = jev[len(rows)]
        it = kw.pop("generator").initial_seed()
        pre, n = e["pre"], int(e["pre"].n_alive)
        assert model.num_points == n, f"iteration {it}: Gaussian count"
        key, draws = e["key"], []
        for _ in range(2):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, (pre.capacity,
                                                             3)))[:n])
        extra = kw["extra_split_mask"]
        dp = _decisions(_np(model.xyz_gradient_accum), _np(model.denom),
                        _np(model.scaling), _np(model.opacity),
                        _np(model.xyz), extra.numpy(), opt, extent)
        dj = _decisions(
            np.asarray(pre.xyz_gradient_accum)[:n],
            np.asarray(pre.denom)[:n],
            np.asarray(pre.params["scaling"])[:n],
            np.asarray(pre.params["opacity"])[:n],
            np.asarray(pre.params["xyz"])[:n],
            np.asarray(e["extra"])[:n], opt, extent)
        # JAX reports appends and prunes; the replay splits the appends
        assert dj["cloned"] + 2 * dj["n_split"] == int(e["res"].requested)
        assert dj["pruned"] == int(e["res"].pruned)
        res = port_dp(model, adam, max_grad, min_opacity, extent,
                      noise=torch.tensor(np.stack(draws)), **kw)
        assert (res.cloned, res.split, res.pruned) == (
            dp["cloned"], dp["n_split"], dp["pruned"])
        row = dict(it=it, n=n, cloned=(res.cloned, dj["cloned"]),
                   split=(res.split, dj["n_split"]),
                   distance=(int(extra.sum()), int(dj["extra"].sum())),
                   pruned=(res.pruned, dj["pruned"]), prox=(0, e["prox"]))
        rows.append(row)
        if any(row[k][0] != row[k][1]
               for k in ("cloned", "split", "distance", "pruned")):
            flips.append((it, _judge_flips(dp, dj, f"iteration {it}")))
            pending.append(e)
        if it >= opt.proximity_until_iter and pending:
            restart(model, adam, pending.pop())
        return res

    def p_prox(model, adam, idx, mask):
        appended = port_prox(model, adam, idx, mask)
        row, e = rows[-1], jev[len(rows) - 1]
        row["prox"] = (appended, e["prox"])
        if pending:
            restart(model, adam, pending.pop())
        else:
            assert appended == e["prox"], f"iteration {row['it']}: proximity"
        return appended

    class PortScene(fsgs_loop.Scene):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaussians = gm.from_jax_state(init[0], device="cpu").model

    peval = []
    monkeypatch.setattr(fsgs_loop, "densify_and_prune", p_densify)
    monkeypatch.setattr(fsgs_loop, "proximity_densify", p_prox)
    monkeypatch.setattr(fsgs_loop, "Scene", PortScene)
    monkeypatch.setattr(fsgs_loop, "evaluate_cameras",
                        lambda *a, **kw: peval.append(port_eval(*a, **kw))
                        or peval[-1])
    random.seed(0)
    np.random.seed(0)
    counts = fsgs_loop.train_fsgs(dataset("port"), opt, pipe, run,
                                  torch.device("cpu"))

    print("\niteration  Gaussians  cloned  split  distance  pruned  "
          "proximity  (port / JAX)")
    for r in rows:
        print(f"{r['it']:9d}  {r['n']:9d}  " + "  ".join(
            "{} / {}".format(*r[k]) for k in ("cloned", "split", "distance",
                                              "pruned", "prox")))
    print("flips (iteration, Gaussians):", flips)
    assert len(rows) == len(jev) == 4
    # every mechanism fired: grad splits and clones, distance splits,
    # proximity appends, opacity prunes after the reset, pseudo steps
    assert sum(r["cloned"][1] for r in rows) > 0
    assert sum(r["split"][1] - r["distance"][1] for r in rows) > 0
    assert sum(r["distance"][1] for r in rows) > 0
    assert sum(r["prox"][1] for r in rows) > 0
    assert rows[-1]["pruned"][1] > rows[-1]["split"][1]
    assert counts["warped_steps"] > 0 and counts["warped_applied"] > 0
    (jt, _), (pt, _) = jeval, peval          # test views, then train views
    assert abs(pt["psnr"] - jt["psnr"]) <= LOOP_PSNR_TOL, (pt, jt)


def _jax_fewshot_script():
    """`scripts/fsgs_fewshot_bench.py` as a module (its imports of JAX sit
    inside the functions that build the scene)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "fsgs_fewshot_bench", os.path.join(REPO, "scripts",
                                           "fsgs_fewshot_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arm", ["fsgs_dense", "fsgs_sparse", "fsgs_nodepth",
                                 "fsgs_noprox", "dngaussian",
                                 "dngaussian_sh", "3dgs"])
def test_fewshot_arm_commands_match_the_jax_script(arm, tmp_path,
                                                   monkeypatch):
    """Each arm's train, render and metrics command lines are the JAX
    script's (`run_arm`, its subprocess calls recorded) once the module
    form, `--device` and `--seed` are set aside; `dngaussian_sh` is the
    JAX `dngaussian` arm with `--use_neural 0`."""
    from sparse_view_3dgs_pack_tpu_torch import fewshot
    script = _jax_fewshot_script()
    jarm = "dngaussian" if arm == "dngaussian_sh" else arm
    method, schedule, _ = fewshot.ARMS[arm]
    assert script.ARMS[jarm][:2] == (method, schedule)
    iters = 10_000 if schedule == "fsgs" else 6_000
    calls = []
    monkeypatch.setattr(script.subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    script.run_arm(jarm, "scene", str(tmp_path), 10_000, 6_000, 400, "py")
    model = os.path.join(str(tmp_path), jarm)
    port = fewshot.arm_commands(arm, "scene", model, iters, 400, "cuda",
                                seed=2)
    pkg = "sparse_view_3dgs_pack_tpu_torch"
    for cmd, want, stage in zip(port, calls, ("train", "render",
                                              "metrics")):
        assert cmd[1:3] == ["-m", f"{pkg}.{stage}"]
        rest = cmd[3:]
        for flag, value in (("--device", "cuda"), ("--seed", "2")):
            if flag in rest:
                i = rest.index(flag)
                assert rest[i + 1] == value
                del rest[i:i + 2]
        if arm == "dngaussian_sh" and stage == "train":
            assert rest[-2:] == ["--use_neural", "0"]
            rest = rest[:-2]
        assert ["py", f"{stage}.py", *rest] == want, stage
