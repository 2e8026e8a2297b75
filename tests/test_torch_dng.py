"""Port parity for the DNGaussian slice: the neural field (values,
gradients, the npz in both directions), the depth-normalisation losses,
`render_core(opacity_override=…)` and `render_neural`, `prune_only`, the
field's LR groups, the near-range mask, and one whole `dng_step` with the
soft pass and the smoothness term on, for `use_neural` 0 and 1.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its XLA tiled path (`use_pallas=False`), its step compiled
once per `use_neural` by a module-scoped fixture. Gradients of a whole
step are read from the first Adam moment of each package: from zero
moments, the passes' Adam calls leave m a fixed combination of the
passes' gradients on both sides."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import renderer as jax_renderer
from sparse_view_3dgs_pack_tpu.losses import dng as jax_losses
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.models import neural_field as jax_nf
from sparse_view_3dgs_pack_tpu.ops import hashgrid as jax_hashgrid
from sparse_view_3dgs_pack_tpu.ops.projection import \
    project_gaussians as jax_project_gaussians
from sparse_view_3dgs_pack_tpu.ops.rasterize_ref import \
    rasterize_dense as jax_rasterize_dense
from sparse_view_3dgs_pack_tpu.ops.rasterize_tiles import RasterConfig
from sparse_view_3dgs_pack_tpu.train import densify as jax_densify
from sparse_view_3dgs_pack_tpu.train import dng_loop as jax_dng
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train import step as jax_step
from sparse_view_3dgs_pack_tpu_torch import renderer, testing
from sparse_view_3dgs_pack_tpu_torch.losses import dng as losses
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.models import neural_field as nf
from sparse_view_3dgs_pack_tpu_torch.ops import hashgrid
from sparse_view_3dgs_pack_tpu_torch.train import densify, dng_loop, optim
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank
import torch_port  # noqa: F401  (one intra-op thread)

PARAMS = gm.PARAM_NAMES
W, H = 48, 32
RASTER = RasterConfig(max_pairs=1 << 15, max_per_tile=1024, tile_batch=16)
# a small field with dense (4, 8) and hashed (16, 32) levels
GRID = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=10, desired_resolution=32)
JCFG = jax_nf.NeuralFieldConfig(grid=jax_hashgrid.HashGridConfig(**GRID),
                                bound=1.5)
TCFG = nf.NeuralFieldConfig(grid=hashgrid.HashGridConfig(**GRID), bound=1.5)
BETA1 = 0.9
FIELD_TOL = 1e-5
LOSS_RTOL = 1e-6
# gradients of a step or a render, of each group's largest (the JAX path
# differentiates its blend scan, the port runs the analytic backward; the
# FSGS step test holds the same)
GRAD_TOL = 5e-5
IMAGE_TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jax_field(seed=0):
    """A JAX field pytree (numpy leaves) with its table spread to N(0, 0.3)
    so the encoding is far from constant."""
    params = jax.tree.map(np.asarray, jax_nf.init_neural_field(
        jax.random.PRNGKey(seed), JCFG))
    params["encoder"] = (np.random.default_rng(seed).normal(
        size=params["encoder"].shape) * 0.3).astype(np.float32)
    return params


def _leaves(params: dict, field: nf.NeuralField):
    """(port name, JAX leaf) for every parameter of the field."""
    return [(name, np.asarray(nf.jax_leaf(params, name)))
            for name in field.params()]


# ---------------------------------------------------------- neural field
def test_neural_forward_matches_jax():
    """`neural_forward` after `from_jax_params`: sigma and colour, and the
    gradients of every parameter and of the points, ≤ 1e-5 (gradients of
    each group's largest)."""
    params = _jax_field()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.4, 1.4, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c_s = rng.normal(size=400).astype(np.float32)
    c_c = rng.normal(size=(400, 3)).astype(np.float32)

    def f(p, xx):
        s, c = jax_nf.neural_forward(p, xx, jnp.asarray(d), JCFG)
        return jnp.sum(s * c_s) + jnp.sum(c * c_c), (s, c)

    (jg, jgx), (js, jc) = jax.jit(jax.grad(f, argnums=(0, 1),
                                           has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    field = nf.from_jax_params(params, TCFG, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    s, c = field.neural_forward(xt, torch.tensor(d))
    ((s * torch.tensor(c_s)).sum() + (c * torch.tensor(c_c)).sum()).backward()
    np.testing.assert_allclose(_np(s), np.asarray(js), atol=FIELD_TOL)
    np.testing.assert_allclose(_np(c), np.asarray(jc), atol=FIELD_TOL)
    grads = dict(field.named_parameters())
    for name, want in _leaves(jax.tree.map(np.asarray, jg), field):
        got = _np(grads[name].grad)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                   atol=FIELD_TOL * np.abs(want).max())
    want = np.asarray(jgx)
    np.testing.assert_allclose(_np(xt.grad), want, rtol=0,
                               atol=FIELD_TOL * np.abs(want).max())


def test_neural_npz_round_trip_both_ways(tmp_path):
    """An npz written by the JAX package loads in the port bit for bit, and
    the port's npz loads in the JAX package bit for bit, same config."""
    params = _jax_field(2)
    jpath = str(tmp_path / "jax.npz")
    jax_nf.save_neural_npz(jpath, jax.tree.map(jnp.asarray, params), JCFG)
    field = nf.load_neural_npz(jpath, device="cpu")
    assert field.cfg == TCFG
    for name, want in _leaves(params, field):
        np.testing.assert_array_equal(_np(field.params()[name]), want, name)
    tpath = str(tmp_path / "port.npz")
    nf.save_neural_npz(tpath, field)
    assert sorted(np.load(tpath).files) == sorted(np.load(jpath).files)
    back, cfg = jax_nf.load_neural_npz(tpath)
    assert cfg == JCFG
    for name, want in _leaves(params, field):
        np.testing.assert_array_equal(np.asarray(nf.jax_leaf(back, name)),
                                      want, name)


def test_neural_lrs_match_jax_lr_tree():
    """The table at the grid LR, the MLPs at the net LR, coord_center 0."""
    params = _jax_field()
    want = jax_dng.neural_lr_tree(params, 5e-3, 5e-4)
    field = nf.from_jax_params(params, TCFG, device="cpu")
    got = dng_loop.neural_lrs(field)
    assert set(got) == set(field.params())
    for name in got:
        assert np.float32(got[name]) == np.asarray(nf.jax_leaf(want, name))


# ---------------------------------------------------------------- losses
def _maps(seed=0):
    """A rendered-like depth map and a prior (255 − disparity), both with
    a constant 16×16 block (a constant patch at every patch size ≤ 16
    that divides it, and part of one otherwise), and an image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (2.0 + np.sin(xx / 5.0) * np.cos(yy / 7.0)
             + 0.2 * rng.random((H, W))).astype(np.float32)
    prior = (255.0 - 60.0 / depth + 3 * rng.random((H, W))).astype(
        np.float32)
    depth[:16, :16] = 2.5
    prior[:16, :16] = 200.0
    image = rng.random((H, W, 3)).astype(np.float32)
    return depth, prior, image


# the arrays are compared on the depth map: on the prior (≈ 200) the two
# packages' float32 patch means differ by an ulp of 200, which the
# standardisation carries into every element; the losses take the prior
_LOSSES = {
    "patchify": lambda m, d, p, i: m.patchify(d, 8),
    "normalize_patches": lambda m, d, p, i: m.normalize_patches(
        m.patchify(d, 8)),
    "normalize_patches_std": lambda m, d, p, i: m.normalize_patches(
        m.patchify(d, 8), std=0.5),
    "margin_l2_loss": lambda m, d, p, i: m.margin_l2_loss(d, p / 100.0,
                                                          0.3),
    "margin_l1_loss": lambda m, d, p, i: m.margin_l1_loss(d, p / 100.0,
                                                          0.3),
    "patch_norm_mse_loss": lambda m, d, p, i: m.patch_norm_mse_loss(
        d, p, 8, 0.01),
    "patch_norm_mse_loss_global": lambda m, d, p, i:
        m.patch_norm_mse_loss_global(d, p, 11, 0.01),
    "loss_depth_smoothness": lambda m, d, p, i: m.loss_depth_smoothness(
        d, i),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_dng_losses_match_jax(name):
    """Every function of `losses/dng.py` on maps with a constant patch:
    ≤ 1e-6 relative (of the largest value for the arrays); the patch-norm
    losses' gradients finite there."""
    depth, prior, image = _maps()
    fn = _LOSSES[name]
    want = np.asarray(fn(jax_losses, jnp.asarray(depth), jnp.asarray(prior),
                         jnp.asarray(image)))
    d = torch.tensor(depth, requires_grad=True)
    got = fn(losses, d, torch.tensor(prior), torch.tensor(image))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=LOSS_RTOL * max(np.abs(want).max(),
                                                    1e-30))
    if got.ndim == 0:
        assert float(got.detach()) > 0, name
        got.backward()
        assert bool(torch.isfinite(d.grad).all()), name


# ------------------------------------------------------- DNG fixture
def _fixture(n=200, seed=3):
    """A JAX state of Gaussians (SH 1) before 3 orbit cameras with random
    targets, partial alpha masks and a 255 − disparity depth map per view
    (what the DNG loop puts in the bank), and both banks."""
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
        disparity = 255.0 * (0.5 + 0.5 * np.sin(xx / (6.0 + i) + yy / 9.0))
        c.invdepthmap = (255.0 - disparity).astype(np.float32)
        c.depth_mask = np.ones((H, W), np.float32)
        c.depth_reliable = True
    return (state, cams, jax_step.CameraBank.from_cameras(cams),
            CameraBank.from_cameras(cams, 3, "cpu"))


# -------------------------------------------------- render_core override
# The JAX XLA path expands each Gaussian's quadratic form into a
# polynomial in the tile's local coordinates (`rasterize_tiles.py:117-124`),
# which cancels: on this fixture its alpha lands 1.2e-5 from a float64
# evaluation where the port's is within 8e-8. The images are therefore
# held to the JAX package's dense oracle at 1e-5, and to the XLA path's
# `render_core` at that path's own error.
XLA_IMAGE_TOL = 5e-5


@pytest.mark.parametrize("kind", ["neural", "hard"])
def test_render_core_opacity_override_matches_jax(kind):
    """`render_core(opacity_override=…)` in training mode: the images
    within 1e-5 (depth: of its largest) of JAX `project_gaussians` +
    `rasterize_dense` on the same overrides, and within XLA_IMAGE_TOL of
    JAX `render_core`; the gradients of xyz, scaling and rotation (and of
    the override colours and opacities when they train) within 5e-5 of
    each group's largest under `jax.grad` of `render_core`. `neural`:
    per-Gaussian colours and opacities under a loss of every output;
    `hard`: DNGaussian's depth pass, unit colours, a constant 0.95 opacity
    that needs no gradient, and only the expected depth in the loss (zero
    colour and alpha cotangents into the backward)."""
    state, cams, _, tbank = _fixture(seed=5)
    n = int(state.n_alive)
    rng = np.random.default_rng(7)
    if kind == "neural":
        color = rng.random((n, 3)).astype(np.float32)
        opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    else:
        color = np.ones((n, 3), np.float32)
        opac = np.full(n, 0.95, np.float32)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((H, W, 3), (H, W), (H, W), (H, W))]
    if kind == "hard":
        cot = [np.zeros_like(cot[0]), np.zeros_like(cot[1]), cot[2],
               np.zeros_like(cot[3])]
    groups = ("xyz", "scaling", "rotation")
    cam = jax_step.CameraBank.from_cameras(cams).camera(
        jnp.asarray(0, jnp.int32))

    def jloss(p, col, op):
        full = {k: v for k, v in state.params.items()}
        full.update({k: p[k] for k in groups})
        res = jax_renderer.render_core(
            full, jnp.ones(256), jnp.eye(3, 4), cam, W, H, jnp.zeros(3), 1,
            RASTER, override_color=jnp.zeros((256, 3)).at[:n].set(col),
            opacity_override=jnp.zeros(256).at[:n].set(op))
        outs = (res.render, res.alpha, res.expected_depth, res.depth)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    (jg, jgc, jgo), jouts = jax.jit(jax.grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        {k: state.params[k] for k in groups}, jnp.asarray(color),
        jnp.asarray(opac))
    p = {k: np.asarray(v)[:n] for k, v in state.params.items()}
    proj = jax_project_gaussians(
        means3d=jnp.asarray(p["xyz"]), scales=jnp.exp(p["scaling"]),
        quats=jnp.asarray(p["rotation"]), opacities=jnp.asarray(opac),
        viewmat=cam.viewmat, full_proj=cam.full_proj,
        cam_center=cam.cam_center, tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, width=W, height=H, sh=None, sh_degree=1,
        colors_precomp=jnp.asarray(color))
    dense = jax_rasterize_dense(proj, W, H, jnp.zeros(3))
    oracle = (jnp.clip(dense.color, 0.0, 1.0), dense.alpha, dense.depth,
              dense.invdepth)

    model = gm.from_jax_state(state, device="cpu").model
    tcol = torch.tensor(color, requires_grad=kind == "neural")
    top = torch.tensor(opac, requires_grad=kind == "neural")
    res = renderer.render_core(model.params(), model.exposure[0],
                               tbank.camera(0), W, H, torch.zeros(3), 1,
                               override_color=tcol, inference=False,
                               opacity_override=top)
    outs = (res.render, res.alpha, res.expected_depth, res.depth)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cot)).backward()
    for o, ref, j, name in zip(outs, oracle, jouts,
                               ("render", "alpha", "depth", "invdepth")):
        ref = np.asarray(ref)
        scale = np.abs(ref).max() if name == "depth" else 1.0
        np.testing.assert_allclose(_np(o), ref, atol=IMAGE_TOL * scale,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(_np(o), np.asarray(j), err_msg=name,
                                   atol=XLA_IMAGE_TOL * scale, rtol=0)
    checks = [(getattr(model, k).grad, np.asarray(jg[k])[:n], k)
              for k in groups]
    if kind == "neural":
        checks += [(tcol.grad, jgc, "color"), (top.grad, jgo, "opacity")]
    for got, want, name in checks:
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(_np(got), want, rtol=0, err_msg=name,
                                   atol=GRAD_TOL * np.abs(want).max())
    assert model.opacity.grad is None and model.features_dc.grad is None


def test_render_neural_matches_jax():
    """`render_neural` against JAX `render_neural` (XLA path) on large
    faint Gaussians, whose α ≥ 1/255 ellipse lies inside the 3σ square so
    that the port's 32×16 inference tiles and JAX's 16×16 cover the same
    pixels: colour, alpha and expected depth ≤ 1e-5."""
    cloud = testing.make_sh3_cloud(0, 300, extent=1.0,
                                   scale_range=(0.3, 0.5))
    cloud["opacity"][:] = np.random.default_rng(3).uniform(
        -4.0, -3.0, (300, 1)).astype(np.float32)
    f = cloud["features"]
    state = jax_gm.create_from_pcd(cloud["xyz"], np.zeros((300, 3)),
                                   n_images=1, sh_degree=3, capacity=300)
    state = state._replace(params={
        "xyz": cloud["xyz"], "features_dc": f[:, :1],
        "features_rest": f[:, 1:], "scaling": cloud["scales"],
        "rotation": cloud["quats"], "opacity": cloud["opacity"]})
    state = state._replace(params={k: jnp.asarray(v, jnp.float32)
                                   for k, v in state.params.items()})
    model = gm.from_jax_state(state, device="cpu").model
    params = _jax_field(4)
    cam = testing.make_orbit_cameras(1, radius=3.0, width=W, height_px=H)[0]
    want = jax_renderer.render_neural(
        state, cam, [0.0, 0.0, 0.0], jax.tree.map(jnp.asarray, params),
        JCFG, config=RASTER, use_pallas=False)
    field = nf.from_jax_params(params, TCFG, device="cpu")
    got = renderer.render_neural(model, cam, [0.0, 0.0, 0.0], field)
    for k in ("render", "alpha", "expected_depth"):
        np.testing.assert_allclose(_np(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   atol=IMAGE_TOL, rtol=0, err_msg=k)
    assert float(got.alpha.max()) > 0.05


# ------------------------------------------------------------ prune_only
def test_prune_only_matches_jax():
    """An arbitrary mask pruned from the parameters, both Adam moments and
    the densification statistics, bit for bit against JAX `prune_only`."""
    state, _, _, _ = _fixture()
    n = int(state.n_alive)
    rng = np.random.default_rng(11)
    jadam = jax_optim.init_adam(state.params)
    jadam = jadam._replace(
        m={k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
           for k, v in jadam.m.items()},
        v={k: jnp.asarray(rng.random(v.shape).astype(np.float32))
           for k, v in jadam.v.items()}, step=jnp.asarray(7, jnp.int32))
    stats = {k: rng.random(256).astype(np.float32)
             for k in gm.STAT_NAMES}
    state = state._replace(**{k: jnp.asarray(v) for k, v in stats.items()})
    mask = np.zeros(256, bool)
    mask[:n] = rng.random(n) < 0.3
    js, ja = jax_densify.prune_only(state, jadam, jnp.asarray(mask))
    port = gm.from_jax_state(state, jadam, device="cpu")
    pruned = densify.prune_only(port.model, port.adam,
                                torch.tensor(mask[:n]))
    keep = int(js.n_alive)
    assert pruned == int(mask.sum()) and port.model.num_points == keep
    for k in PARAMS:
        np.testing.assert_array_equal(_np(port.model.params()[k]),
                                      np.asarray(js.params[k])[:keep], k)
        np.testing.assert_array_equal(_np(port.adam.m[k]),
                                      np.asarray(ja.m[k])[:keep], k)
        np.testing.assert_array_equal(_np(port.adam.v[k]),
                                      np.asarray(ja.v[k])[:keep], k)
    for k in gm.STAT_NAMES:
        np.testing.assert_array_equal(_np(getattr(port.model, k)),
                                      np.asarray(getattr(js, k))[:keep], k)
    assert port.adam.step == int(ja.step) == 7


def test_near_range_mask():
    """The spiral prune's mask: a point is in it when its distance to some
    centre is below the range (a float64 numpy check)."""
    rng = np.random.default_rng(12)
    xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    centers = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    got = dng_loop.near_range_mask(torch.tensor(xyz), torch.tensor(centers),
                                   0.3)
    d = np.linalg.norm(xyz[:, None].astype(np.float64) - centers[None],
                       axis=-1)
    np.testing.assert_array_equal(_np(got), (d < 0.3).any(1))
    assert 0 < int(got.sum()) < 500


# ------------------------------------------------------ the whole step
# Adam's first step moves every coordinate by ±lr, the sign of a gradient
# however small, so a gradient within rounding of zero can step the two
# packages apart by 2·lr per pass: a small lr keeps that below the
# tolerance of the passes after it
LR = 1e-6
CAM, PATCH, ACTIVE = 1, 3, 1


@pytest.fixture(scope="module", params=[0, 1], ids=["sh", "neural"])
def stepped(request):
    """One JAX `dng_step` (compiled once per `use_neural`) and the port's
    on the same state, field, view and patch size, with the soft pass and
    the smoothness term on."""
    use_neural = request.param
    state, _, jbank, tbank = _fixture()
    params = _jax_field()
    kw = dict(width=W, height=H, sh_degree=1, error_tolerance=0.01,
              shape_pena=0.002, scale_pena=0.005, opa_pena=0.01,
              use_neural=bool(use_neural), use_soft=True, use_smooth=True)
    jcfg = jax_dng.DNGConfig(raster=RASTER, neural=JCFG, use_pallas=False,
                             **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    jadam = jax_optim.init_adam(state.params)
    jnadam = jax_optim.init_tree_adam(jparams)
    lrs = {k: jnp.asarray(LR, jnp.float32) for k in state.params}
    nlrs = jax_dng.neural_lr_tree(jparams, LR, LR)
    jstate, _, jadam, jnadam, jm = jax_dng.dng_step(
        state, jparams, jadam, jnadam, jbank, jnp.asarray(CAM, jnp.int32),
        jnp.asarray(PATCH, jnp.int32), lrs, nlrs,
        jnp.asarray(ACTIVE, jnp.int32), jnp.zeros(3), jcfg)

    model = gm.from_jax_state(state, device="cpu").model
    field = nf.from_jax_params(params, TCFG, device="cpu")
    adam = optim.init_adam(model.params())
    fadam = optim.init_adam(field.params())
    m = dng_loop.dng_step(model, field, adam, fadam, tbank, CAM, PATCH,
                          {k: LR for k in PARAMS},
                          dng_loop.neural_lrs(field, LR, LR), ACTIVE,
                          torch.zeros(3),
                          dng_loop.DNGConfig(**kw))
    return dict(use_neural=use_neural, n=int(state.n_alive), state=state,
                jstate=jstate, jadam=jadam, jnadam=jnadam, jm=jm,
                model=model, field=field, adam=adam, fadam=fadam, m=m)


def test_dng_step_loss_and_counters_match_jax(stepped):
    """The photometric pass's loss and L1 within 1e-6 relative; both Adam
    step counters equal (3 Gaussian passes, 2 field passes)."""
    s = stepped
    for key in ("loss", "l1"):
        want = float(s["jm"][key])
        assert abs(float(s["m"][key]) - want) <= LOSS_RTOL * abs(want), key
    assert s["adam"].step == int(s["jadam"].step) == 3
    assert s["fadam"].step == int(s["jnadam"].step) == 2


def test_dng_step_gaussian_grads_match_jax(stepped):
    """Every Gaussian group's first Adam moment within 5e-5 of its
    largest; with the neural field the SH get no gradient on either
    side."""
    s = stepped
    n = s["n"]
    zero = () if s["use_neural"] == 0 else ("features_dc", "features_rest")
    for k in PARAMS:
        want = np.asarray(s["jadam"].m[k])[:n] / (1 - BETA1)
        got = _np(s["adam"].m[k]) / (1 - BETA1)
        if k in zero:
            assert not want.any() and not got.any(), k
            continue
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got, want, rtol=0, err_msg=k,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_dng_step_field_grads_match_jax(stepped):
    """The field's first moments within 5e-5 of each leaf's largest; the
    SH variant leaves the field's moments zero on both sides."""
    s = stepped
    for name, want in _leaves(jax.tree.map(np.asarray, s["jnadam"].m),
                              s["field"]):
        got = _np(s["fadam"].m[name])
        if s["use_neural"] == 0:
            assert not want.any() and not got.any(), name
            continue
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                   atol=GRAD_TOL * np.abs(want).max())


def test_dng_step_params_and_stats_match_jax(stepped):
    """The parameters after the step within 6·lr of JAX's (each pass can
    step a near-zero gradient's coordinate the other way) and moved from
    the start; the densification statistics of the photometric pass."""
    s = stepped
    n = s["n"]
    for k in PARAMS:
        start = np.asarray(s["state"].params[k])[:n]
        want = np.asarray(s["jstate"].params[k])[:n]
        got = _np(s["model"].params()[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=6 * LR + 1e-7,
                                   err_msg=k)
        if k in ("xyz", "opacity"):
            assert not np.array_equal(got, start), k
    np.testing.assert_allclose(_np(s["model"].xyz_gradient_accum),
                               np.asarray(s["jstate"].xyz_gradient_accum)[:n],
                               rtol=1e-4, atol=1e-9)
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(_np(getattr(s["model"], k)),
                                      np.asarray(getattr(s["jstate"], k))[:n])


# -------------------------------------------------------------- the loop
def test_train_dngaussian_runs_every_pass_and_prunes(tmp_path, monkeypatch):
    """The loop on a 32-px forward-facing scene with a small field and the
    near-range prune from iteration 1: the soft pass runs twice, the prune
    removes some of the points (a range holding a tenth of the init), the
    saved PLY has the rest, and the field is saved beside it."""
    from argparse import ArgumentParser, Namespace
    from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                        PipelineParams)
    from sparse_view_3dgs_pack_tpu_torch.utils.pose_utils import \
        generate_spiral_path
    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=32, n_gauss=200,
                                            n_dense=150, n_sparse=40)
    monkeypatch.setattr(dng_loop, "NeuralFieldConfig",
                        lambda bound: TCFG._replace(bound=bound))
    monkeypatch.setattr(dng_loop, "NEAR_PRUNE_FROM_ITER", 0)
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "dngaussian"), PipelineParams(parser)
    args = parser.parse_args(["--iterations", "3", "--soft_depth_start",
                              "1", "--densify_until_iter", "0"])
    out = tmp_path / "out"
    os.makedirs(out)
    dataset = Namespace(source_path=scene, model_path=str(out), sh_degree=1,
                        images="images", depths="", eval=True,
                        train_test_exp=False, n_views=3,
                        point_cloud_type="dense", resolution=-1,
                        white_background=False, data_device="cpu")
    pipe = pp.extract(args)
    pipe.debug_from = -1
    run = Namespace(save_iterations=[3], test_iterations=[],
                    depth_estimator="precomputed")
    # a range that holds some of the init points: the 10th percentile of
    # their distance to the spiral's nearest camera
    from sparse_view_3dgs_pack_tpu_torch.data import readers
    from sparse_view_3dgs_pack_tpu_torch.data.camera_utils import \
        camera_list_from_cam_infos
    info = readers.read_colmap_scene(scene, eval=True, n_views=3,
                                     point_cloud_type="dense")
    cams = camera_list_from_cam_infos(info.train_cameras, 1.0, dataset,
                                      False, False)
    centers = np.stack([c.camera_center for c in generate_spiral_path(
        cams, dng_loop.SPIRAL_FRAMES)])
    d = np.linalg.norm(info.point_cloud.points[:, None] - centers[None],
                       axis=-1).min(1)
    near = float(np.percentile(d, 10))
    counts = dng_loop.train_dngaussian(dataset, op.extract(args), pipe, run,
                                       torch.device("cpu"), near_range=near)
    assert counts["soft_passes"] == 2 and counts["near_prunes"] == 1
    assert 0 < counts["near_pruned"] < 150
    it_dir = out / "point_cloud" / "iteration_3"
    model = gm.load_ply(str(it_dir / "point_cloud.ply"), sh_degree=1,
                        device="cpu")
    assert model.num_points == 150 - counts["near_pruned"]
    field = nf.load_neural_npz(str(it_dir / "neural_renderer.npz"), "cpu")
    assert field.cfg == TCFG._replace(bound=field.cfg.bound)


@pytest.mark.parametrize("arm,neural", [("dngaussian", None),
                                        ("dngaussian_sh", "0")])
def test_fewshot_dng_arms(arm, neural):
    """The few-shot CLI's DNGaussian arms (JAX script `:209`): the train
    CLI's `--method dngaussian` with the precomputed priors at the 6k
    schedule, the SH variant with `--use_neural 0`, each seed handed to
    `--seed`."""
    from sparse_view_3dgs_pack_tpu_torch import fewshot
    train, render, _ = fewshot.arm_commands(arm, "scene", "out", 6000, 400,
                                            "cuda", seed=2)
    flags = " ".join(train)
    assert "--method dngaussian" in flags and "--iterations 6000" in flags
    assert "--depth_estimator precomputed" in flags and "--seed 2" in flags
    assert ("--use_neural" in flags) == (neural is not None)
    if neural:
        assert f"--use_neural {neural}" in flags
    assert fewshot.ARMS[arm][1] == "dng"
    assert "--skip_train" in render
