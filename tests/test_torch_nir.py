"""Port parity for the mult-dwtgs slice: the NIR losses, the NIR
parameters (`create_from_pcd(use_nir=True)`, the PLY both ways, the
JAX-state bridge), densification with NIR rows, and three whole
`nir_step`s against JAX `nir_step`.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its XLA tiled path (`use_pallas=False`), its step compiled
once by a module-scoped fixture. Gradients of a step are read from each
package's first Adam moment at a tiny LR (the method of
`tests/test_torch_dng.py`): from zero moments, step t leaves
m = Σ 0.1·0.9^(t-s)·g_s on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.losses import nir as jax_nir
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.ops.rasterize_tiles import RasterConfig
from sparse_view_3dgs_pack_tpu.train import densify as jax_densify
from sparse_view_3dgs_pack_tpu.train import nir_loop as jax_nir_loop
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train import step as jax_step
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.losses import nir
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.train import densify, nir_loop, optim
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank, StepConfig
import torch_port  # noqa: F401  (one intra-op thread)

# `tests/test_methods.py::_state_and_bank`'s sizes
N, CAP, W, H, SH = 150, 512, 48, 32, 2
RASTER = RasterConfig(max_pairs=1 << 15, max_per_tile=1024, tile_batch=16)
ROWS = gm.PARAM_NAMES + ("nir_albedo",)
GROUPS = ROWS + ("nir_gain",)
LOSS_RTOL = 1e-6
# a loss's own gradient, of its largest (`tests/test_torch_losses.py`'s:
# the SSIM convolutions sum in another order)
LOSS_GRAD_TOL = 1e-5
GRAD_TOL = 5e-5
STAT_TOL = 1e-5
# an image of the port against the JAX XLA path (`tests/test_torch_dng.py`'s)
IMAGE_TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------- losses
def _nir_maps(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    pred = (0.5 + 0.4 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
            + 0.05 * rng.random((H, W))).astype(np.float32)
    gt = np.clip(pred + rng.normal(size=(H, W)) * 0.1, 0, 1).astype(
        np.float32)
    rgb_pred = rng.random((H, W, 3)).astype(np.float32)
    rgb_gt = rng.random((H, W, 3)).astype(np.float32)
    return pred, gt, rgb_pred, rgb_gt


_LOSSES = {
    "l1_loss_nir": lambda m, p, g, rp, rg: m.l1_loss_nir(p, g),
    "ssim_loss_nir": lambda m, p, g, rp, rg: m.ssim_loss_nir(p, g),
    "ssim_loss_nir_hw1": lambda m, p, g, rp, rg: m.ssim_loss_nir(
        p[..., None], g[..., None]),
    "combined_nir_loss": lambda m, p, g, rp, rg: m.combined_nir_loss(p, g),
    "combined_nir_loss_weights": lambda m, p, g, rp, rg:
        m.combined_nir_loss(p, g, l1_weight=0.7, ssim_weight=0.5),
    "compute_combined_residuals": lambda m, p, g, rp, rg:
        m.compute_combined_residuals(rp, rg, p, g),
    "compute_combined_residuals_hw1": lambda m, p, g, rp, rg:
        m.compute_combined_residuals(rp, rg, p[..., None], g[..., None]),
    "compute_combined_residuals_rgb": lambda m, p, g, rp, rg:
        m.compute_combined_residuals(rp, rg),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_nir_losses_match_jax(name):
    """Every function of `losses/nir.py` ≤ 1e-6 relative (of the largest
    value for the residual maps); the scalar losses' gradients ≤ 1e-5 of
    their largest."""
    maps = _nir_maps()
    fn = _LOSSES[name]
    jp = jnp.asarray(maps[0])

    def jfn(p):
        return fn(jax_nir, p, *map(jnp.asarray, maps[1:]))

    want = np.asarray(jfn(jp))
    p = torch.tensor(maps[0], requires_grad=True)
    got = fn(nir, p, *map(torch.tensor, maps[1:]))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=LOSS_RTOL * np.abs(want).max())
    if got.ndim == 0:
        got.backward()
        jg = np.asarray(jax.grad(jfn)(jp))
        np.testing.assert_allclose(_np(p.grad), jg, rtol=0,
                                   atol=LOSS_GRAD_TOL * np.abs(jg).max())


# ------------------------------------------------------- NIR parameters
def _nir_state(seed=0, n=N):
    """A JAX NIR state (SH 2) with spread parameters, an NIR albedo far
    from its constant start and a gain of 1.3, before 3 orbit cameras with
    random RGB and NIR targets (`_state_and_bank`'s), and both banks."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=3, sh_degree=SH,
                                   capacity=CAP, use_nir=True)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["features_rest"][:n] = rng.normal(size=(n, 8, 3)) * 0.2
    params["opacity"][:n, 0] = rng.uniform(-1.0, 2.5, n)
    params["scaling"][:n] = np.log(rng.uniform(0.04, 0.14, (n, 3)))
    params["rotation"][:n] = rng.normal(size=(n, 4))
    params["nir_albedo"][:n, 0] = rng.normal(size=n)
    params["nir_gain"][:] = 1.3
    state = state._replace(params={k: jnp.asarray(v)
                                   for k, v in params.items()})
    cams = jax_testing.make_orbit_cameras(3, radius=3.5, width=W,
                                          height_px=H)
    for c in cams:
        c.image = rng.random((H, W, 3)).astype(np.float32)
        c.alpha_mask = (rng.random((H, W)) > 0.1).astype(np.float32)
        c.nir = rng.random((H, W)).astype(np.float32)
    return (state, cams, jax_step.CameraBank.from_cameras(cams),
            CameraBank.from_cameras(cams, 3, "cpu"))


def test_camera_bank_carries_nir():
    """The bank's `nir` is (N, H, W) and equal to JAX's; without any NIR
    image it is (N, 1, 1) zeros on both sides."""
    _, cams, jbank, tbank = _nir_state()
    np.testing.assert_array_equal(_np(tbank.nir), np.asarray(jbank.nir))
    assert tbank.nir.shape == (3, H, W)
    for c in cams:
        c.nir = None
    dummy = CameraBank.from_cameras(cams, 3, "cpu").nir
    np.testing.assert_array_equal(
        _np(dummy), np.asarray(jax_step.CameraBank.from_cameras(cams).nir))
    assert dummy.shape == (3, 1, 1) and not dummy.any()


def test_create_from_pcd_use_nir_matches_jax():
    """Every parameter, the NIR albedo (0 = inverse_sigmoid(0.5)) and gain
    (1) too, where the JAX windowed 3-NN is exhaustive (60 points); the
    model without `use_nir` has no NIR parameters."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    cols = rng.random((60, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=2, sh_degree=1,
                                   capacity=256, use_nir=True)
    model = gm.create_from_pcd(pts, cols, n_images=2, sh_degree=1,
                               use_nir=True, device="cpu")
    assert set(model.params()) == set(state.params) == set(GROUPS)
    for k in GROUPS:
        want = np.asarray(state.params[k])
        want = want if k == "nir_gain" else want[:60]
        np.testing.assert_allclose(_np(model.params()[k]), want, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert not gm.create_from_pcd(pts, cols, n_images=2, sh_degree=1,
                                  device="cpu").has_nir


def test_save_ply_of_nir_state_is_byte_identical_and_loads(tmp_path):
    """`save_ply` of the bridged NIR state equals the JAX `save_ply` byte
    for byte (`nir_albedo` after the rotations, no gain); the port's
    `load_ply` reads the albedo back with the gain reset to 1, as JAX's
    does."""
    state = _nir_state()[0]
    model = gm.from_jax_state(state, device="cpu").model
    assert _np(model.nir_gain)[0] == np.float32(1.3)
    jpath, tpath = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_gm.save_ply(state, jpath)
    gm.save_ply(model, tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    back = gm.load_ply(tpath, sh_degree=SH, device="cpu")
    jback = jax_gm.load_ply(jpath, sh_degree=SH)
    np.testing.assert_array_equal(_np(back.nir_albedo),
                                  np.asarray(state.params["nir_albedo"])[:N])
    np.testing.assert_array_equal(_np(back.nir_gain),
                                  np.asarray(jback.params["nir_gain"]))
    assert _np(back.nir_gain)[0] == 1.0
    assert back.row_names() == ROWS


# ----------------------------------------------------- densification
def _with_stats_and_moments(state, seed):
    """The state with statistics that select clones and splits, low
    opacities that prune, and non-zero Adam moments (the gain's too)."""
    rng = np.random.default_rng(seed)
    n = int(state.n_alive)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["scaling"][:n] = np.log(rng.uniform(0.005, 0.08, (n, 3)))
    params["opacity"][:n, 0] = rng.uniform(-6.0, 2.0, n)
    accum = np.zeros(CAP, np.float32)
    denom = np.zeros(CAP, np.float32)
    accum[:n] = rng.uniform(0, 4e-4, n) * 3
    denom[:n] = rng.integers(0, 4, n)
    max_r = np.zeros(CAP, np.float32)
    max_r[:n] = rng.uniform(0, 30, n)
    state = state._replace(
        params={k: jnp.asarray(v) for k, v in params.items()},
        xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        max_radii2d=jnp.asarray(max_r))
    adam = jax_optim.init_adam(state.params)
    adam = adam._replace(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in adam.m.items()},
        v={k: jnp.asarray(rng.random(v.shape).astype(np.float32))
           for k, v in adam.v.items()},
        step=jnp.asarray(7, jnp.int32))
    return state, adam


def _assert_nir_state(port, jstate, jadam):
    """Rows (NIR albedo included) within rtol 1e-6, the gain and its
    moments unchanged and equal, the row moments moved with their rows,
    the statistics equal."""
    n = int(jstate.n_alive)
    model, adam = port.model, port.adam
    assert model.num_points == n and adam.step == int(jadam.step)
    for k in ROWS:
        np.testing.assert_allclose(_np(getattr(model, k)),
                                   np.asarray(jstate.params[k])[:n],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for name in ("m", "v"):
            np.testing.assert_array_equal(
                _np(getattr(adam, name)[k]),
                np.asarray(getattr(jadam, name)[k])[:n],
                err_msg=f"{name}[{k}]")
    np.testing.assert_array_equal(_np(model.nir_gain),
                                  np.asarray(jstate.params["nir_gain"]))
    for name in ("m", "v"):
        np.testing.assert_array_equal(
            _np(getattr(adam, name)["nir_gain"]),
            np.asarray(getattr(jadam, name)["nir_gain"]))
    for k in gm.STAT_NAMES:
        np.testing.assert_array_equal(_np(getattr(model, k)),
                                      np.asarray(getattr(jstate, k))[:n])


def test_densify_and_prune_with_nir_rows_matches_jax():
    """Clones and splits (the JAX draws handed over) copy their source's
    NIR albedo; the prune drops it with its row; `nir_gain` and its
    moments stay as they were."""
    state, jadam = _with_stats_and_moments(_nir_state(seed=2)[0], 2)
    port = gm.from_jax_state(state, jadam, device="cpu")
    gain_m = _np(port.adam.m["nir_gain"]).copy()
    n = int(state.n_alive)
    key = jax.random.PRNGKey(11)
    res = jax_densify.densify_and_prune(state, jadam, key, 0.0002, 0.005,
                                        5.0, max_screen_size=20,
                                        percent_dense=0.01)
    assert int(res.appended) == int(res.requested)
    draws = []
    for _ in range(2):       # the draws of `densify.py:107-109`
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (CAP, 3)))[:n])
    out = densify.densify_and_prune(
        port.model, port.adam, 0.0002, 0.005, 5.0, max_screen_size=20,
        percent_dense=0.01, noise=torch.tensor(np.stack(draws)))
    assert out.cloned > 0 and out.split > 0 and out.pruned > out.split
    _assert_nir_state(port, res.state, res.opt_state)
    np.testing.assert_array_equal(_np(port.adam.m["nir_gain"]), gain_m)


def test_proximity_densify_and_prune_only_with_nir_rows_match_jax():
    """`proximity_densify` appends the neighbour's NIR albedo with zero
    moments; `prune_only` then drops rows with their albedo; the gain and
    its moments never move."""
    state, jadam = _with_stats_and_moments(_nir_state(seed=3)[0], 3)
    port = gm.from_jax_state(state, jadam, device="cpu")
    n = int(state.n_alive)
    rng = np.random.default_rng(4)
    mask = np.zeros(CAP, bool)
    mask[:n] = rng.random(n) < 0.1
    nn_idx = np.zeros((CAP, 3), np.int32)
    nn_idx[:n] = rng.integers(0, n, (n, 3))
    res = jax_densify.proximity_densify(state, jadam, jnp.asarray(nn_idx),
                                        jnp.asarray(mask))
    appended = densify.proximity_densify(port.model, port.adam,
                                         torch.tensor(nn_idx[:n]),
                                         torch.tensor(mask[:n]))
    assert appended == int(res.appended) == 3 * int(mask.sum()) > 0
    _assert_nir_state(port, res.state, res.opt_state)

    n2 = int(res.state.n_alive)
    drop = np.zeros(CAP, bool)
    drop[:n2] = rng.random(n2) < 0.3
    jstate, jadam2 = jax_densify.prune_only(res.state, res.opt_state,
                                            jnp.asarray(drop))
    pruned = densify.prune_only(port.model, port.adam,
                                torch.tensor(drop[:n2]))
    assert pruned == int(drop.sum()) > 0
    _assert_nir_state(port, jstate, jadam2)


# ------------------------------------------------------ the whole step
# Adam's first step moves a coordinate by ±lr whatever the size of its
# gradient: a small lr keeps the two packages' states within rounding
LR = 1e-6
STEPS = (0, 1, 2)   # the camera of each step
ACTIVE = 1


@pytest.fixture(scope="module")
def stepped():
    """Three JAX `nir_step`s (XLA tiled path, compiled once) and three of
    the port's from one bridged NIR state, DWT and patch DWT on (patch
    16); each package's loss, NIR loss, first moments and statistics after
    every step."""
    state, _, jbank, tbank = _nir_state()
    base = dict(width=W, height=H, sh_degree=SH, dwt_enable=True,
                patch_dwt_enable=True, patch_size=16)
    jcfg = jax_nir_loop.NIRConfig(
        base=jax_step.StepConfig(raster=RASTER, use_pallas=False, **base),
        nir_weight=0.5)
    jadam = jax_optim.init_adam(state.params)
    jlrs = {k: jnp.asarray(LR, jnp.float32) for k in state.params}
    jcarry = jnp.ones(())
    model = gm.from_jax_state(state, device="cpu").model
    adam = optim.init_adam(model.params())
    cfg = nir_loop.NIRConfig(base=StepConfig(**base), nir_weight=0.5)
    carry = torch.ones(())
    n = int(state.n_alive)
    out = []
    jstate = state
    for cam in STEPS:
        jstate, jadam, jcarry, jm = jax_nir_loop.nir_step(
            jstate, jadam, jcarry, jbank, jnp.asarray(cam, jnp.int32), jlrs,
            jnp.asarray(ACTIVE, jnp.int32), jnp.zeros(3), jcfg)
        m, carry = nir_loop.nir_step(model, adam, carry, tbank, cam,
                                     {k: LR for k in GROUPS}, ACTIVE,
                                     torch.zeros(3), cfg)
        out.append(dict(
            jm={k: float(jm[k]) for k in ("loss", "l1", "nir")},
            m={k: float(m[k]) for k in ("loss", "l1", "nir")},
            jcarry=float(jcarry), carry=float(carry),
            jmom={k: np.array(v) for k, v in jadam.m.items()},
            mom={k: _np(v).copy() for k, v in adam.m.items()},
            jstats={k: np.array(getattr(jstate, k))[:n]
                    for k in gm.STAT_NAMES},
            stats={k: _np(getattr(model, k)).copy()
                   for k in gm.STAT_NAMES},
            steps=(int(jadam.step), adam.step)))
    return dict(n=n, out=out)


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_nir_step_loss_matches_jax(stepped, i):
    """Step i's loss, L1 and NIR loss within 1e-6 relative, the DWT carry
    too, and both Adam counters at i + 1."""
    s = stepped["out"][i]
    for key in ("loss", "l1", "nir"):
        want = s["jm"][key]
        assert want > 0, key
        assert abs(s["m"][key] - want) <= LOSS_RTOL * abs(want), key
    assert abs(s["carry"] - s["jcarry"]) <= LOSS_RTOL * abs(s["jcarry"])
    assert s["steps"] == (i + 1, i + 1)


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_nir_step_grads_match_jax(stepped, i):
    """Every group's first Adam moment after step i, `nir_albedo` and
    `nir_gain` included, within 5e-5 of its largest."""
    s, n = stepped["out"][i], stepped["n"]
    for k in GROUPS:
        want = s["jmom"][k] if k == "nir_gain" else s["jmom"][k][:n]
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(s["mom"][k], want, rtol=0, err_msg=k,
                                   atol=GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_nir_step_stats_come_from_the_rgb_pass(stepped, i):
    """`xyz_gradient_accum` within 1e-5 of its largest and `denom` and
    `max_radii2d` equal after step i: the statistics of the RGB render
    alone, as JAX passes the screen-space offset to the RGB pass only."""
    s = stepped["out"][i]
    want = s["jstats"]["xyz_gradient_accum"]
    assert want.max() > 0
    np.testing.assert_allclose(s["stats"]["xyz_gradient_accum"], want,
                               rtol=0, atol=STAT_TOL * want.max())
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(s["stats"][k], s["jstats"][k], k)


def test_render_nir_is_the_one_channel_render():
    """`render_nir` against channel 0 of the JAX inference `render_core`
    (XLA path) with colours sigmoid(nir_albedo)·nir_gain (C = 1) on black,
    from one bridged state, ≤ 1e-5. The opacities are made faint
    (sigmoid(-2..-1) < 0.35) so that each α ≥ 1/255 ellipse lies inside
    its 3σ window and the port's 32×16 inference tiles and JAX's 16×16
    cover the same pixels, as in `test_render_neural_matches_jax`."""
    state = _nir_state()[0]
    p = dict(state.params)
    op = np.array(p["opacity"])
    op[:, 0] = np.random.default_rng(3).uniform(-2.0, -1.0, op.shape[0])
    p["opacity"] = jnp.asarray(op)
    state = state._replace(params=p)
    model = gm.from_jax_state(state, device="cpu").model
    cam = testing.make_orbit_cameras(1, radius=3.5, width=W,
                                     height_px=H)[0]
    jcam = jax_testing.make_orbit_cameras(1, radius=3.5, width=W,
                                          height_px=H)[0]
    from sparse_view_3dgs_pack_tpu import renderer as jax_renderer
    col = jax.nn.sigmoid(p["nir_albedo"]) * p["nir_gain"]
    ref = jax_renderer.render_core(
        p, state.alive.astype(jnp.float32), jnp.eye(3, 4), jcam.params(),
        W, H, jnp.zeros(1), SH, RASTER, override_color=col,
        inference=True).render[..., 0]
    with torch.no_grad():
        got = nir_loop.render_nir(model, cam)
    assert got.shape == (H, W) and float(got.max()) > 0.05
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=0,
                               atol=IMAGE_TOL)
