"""Port parity for the training slice (`train/`, `models/gaussians.py`,
`ops/knn.py`): each piece against the JAX package from the same numpy
state — the synthetic generators, Adam and exposure Adam, the LR
schedules, densification statistics, densify-and-prune and opacity reset
(index by index, Adam moments included), `create_from_pcd`, and one
`lgdwt` train step's loss and every gradient before the optimizer."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.ops.rasterize_tiles import RasterConfig
from sparse_view_3dgs_pack_tpu.train import densify as jax_densify
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train import step as jax_step
from sparse_view_3dgs_pack_tpu.utils import general as jax_general
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.ops.knn import dist2_for_scale_init
from sparse_view_3dgs_pack_tpu_torch.train import densify, optim, step
from sparse_view_3dgs_pack_tpu_torch.utils import general

PARAMS = gm.PARAM_NAMES


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_state(model, state, rtol=1e-6, atol=1e-7):
    n = int(state.n_alive)
    assert model.num_points == n
    for k in PARAMS:
        np.testing.assert_allclose(_np(getattr(model, k)),
                                   np.asarray(state.params[k])[:n],
                                   rtol=rtol, atol=atol, err_msg=k)
    for k in gm.STAT_NAMES:
        np.testing.assert_allclose(_np(getattr(model, k)),
                                   np.asarray(getattr(state, k))[:n],
                                   rtol=rtol, atol=atol, err_msg=k)


def _assert_adam(adam, jadam, n, rtol=1e-6, atol=1e-12):
    assert adam.step == int(jadam.step)
    for k in PARAMS:
        for name in ("m", "v"):
            np.testing.assert_allclose(
                _np(getattr(adam, name)[k]),
                np.asarray(getattr(jadam, name)[k])[:n], rtol=rtol,
                atol=atol, err_msg=f"{name}[{k}]")


def test_generators_match_jax():
    """The port's own copies of the synthetic generators give the JAX
    package's numbers from the same seed."""
    a = testing.make_gaussian_cloud(3, 50, extent=0.7, sh_degree=2)
    b = jax_testing.make_gaussian_cloud(3, 50, extent=0.7, sh_degree=2)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(testing.look_at_rt((1.0, 2.0, 3.0), (0, 0, 0)),
                    jax_testing.look_at_rt((1.0, 2.0, 3.0), (0, 0, 0))):
        np.testing.assert_array_equal(x, y)
    for ca, cb in zip(testing.make_orbit_cameras(3, width=40, height_px=24),
                      jax_testing.make_orbit_cameras(3, width=40,
                                                     height_px=24)):
        for x, y in zip(ca.params(), cb.params()):
            np.testing.assert_array_equal(x, y)
        assert (ca.width, ca.height, ca.image_name) == \
            (cb.width, cb.height, cb.image_name)


def _random_params(rng, n, sh_rest=3):
    return {"xyz": rng.normal(size=(n, 3)),
            "features_dc": rng.normal(size=(n, 1, 3)),
            "features_rest": rng.normal(size=(n, sh_rest, 3)),
            "scaling": rng.normal(size=(n, 3)),
            "rotation": rng.normal(size=(n, 4)),
            "opacity": rng.normal(size=(n, 1))}


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_matches_jax(sparse):
    """Six steps of per-group Adam (one global step, eps 1e-15) fed the same
    gradients, with and without the visibility mask, and the exposure Adam
    (eps 1e-8): parameters and moments within rtol 1e-6 (f32 rounding of
    the same expression). Gradients include ±1e-12 entries: the first step
    moves them by ±lr whatever their size."""
    rng = np.random.default_rng(0)
    n = 40
    p0 = {k: v.astype(np.float32) for k, v in _random_params(rng, n).items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    tparams = {k: torch.tensor(v) for k, v in p0.items()}
    jadam = jax_optim.init_adam(jparams)
    tadam = optim.init_adam(tparams)
    exp0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    jexp, texp = jnp.asarray(exp0), torch.tensor(exp0)
    jeadam = jax_optim.init_exposure_adam(jexp)
    teadam = optim.init_exposure_adam(texp)
    lrs = {"xyz": 1.6e-4, "features_dc": 2.5e-3, "features_rest": 1.25e-4,
           "scaling": 5e-3, "rotation": 1e-3, "opacity": 2.5e-2}
    for it in range(6):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(
            -12, 0, size=v.shape)).astype(np.float32) for k, v in p0.items()}
        vis = rng.random(n) > 0.3 if sparse else None
        jparams, jadam = jax_optim.adam_update(
            jparams, {k: jnp.asarray(g) for k, g in grads.items()}, jadam,
            {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
            visibility=None if vis is None else jnp.asarray(vis))
        optim.adam_update(tparams, {k: torch.tensor(g)
                                    for k, g in grads.items()}, tadam, lrs,
                          visibility=None if vis is None
                          else torch.tensor(vis))
        ge = rng.normal(size=exp0.shape).astype(np.float32)
        jexp, jeadam = jax_optim.exposure_adam_update(
            jexp, jnp.asarray(ge), jeadam, jnp.asarray(0.01, jnp.float32))
        optim.exposure_adam_update(texp, torch.tensor(ge), teadam, 0.01)
    for k in PARAMS:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    _assert_adam(tadam, jadam, n)
    np.testing.assert_allclose(texp.numpy(), np.asarray(jexp), rtol=1e-6)
    for name in ("m", "v"):
        np.testing.assert_allclose(_np(getattr(teadam, name)),
                                   np.asarray(getattr(jeadam, name)),
                                   rtol=1e-6)
    assert teadam.step == int(jeadam.step) == 6


def test_lr_schedules_match_jax():
    kw = dict(lr_init=1.6e-4 * 3.5, lr_final=1.6e-6 * 3.5,
              lr_delay_steps=100, lr_delay_mult=0.01, max_steps=3000)
    port, ref = general.get_expon_lr_func(**kw), \
        jax_general.get_expon_lr_func(**kw)
    for s in (0, 1, 50, 99, 100, 1500, 3000, 4000):
        assert math.isclose(port(s), float(ref(s)), rel_tol=2e-6)
    assert general.get_expon_lr_func(0.0, 0.1)(5) == 0.0
    opt = jax_testing.make_dryrun_opt()
    port_s = optim.make_lr_schedules(opt, 2.0)
    ref_s = jax_optim.make_lr_schedules(opt, 2.0)
    for k in PARAMS:
        for s in (1, 700, 30000):
            assert math.isclose(port_s[k](s), float(ref_s[k](s)),
                                rel_tol=2e-6), k


def _jax_state(n=60, capacity=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return jax_gm.create_from_pcd(pts, cols, n_images=2, sh_degree=1,
                                  capacity=capacity), pts, cols


def test_add_densification_stats_matches_jax():
    state, _, _ = _jax_state()
    model = gm.from_jax_state(state, device="cpu").model
    rng = np.random.default_rng(1)
    cap, n = state.capacity, int(state.n_alive)
    for _ in range(3):
        g = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-4
        radii = rng.integers(-3, 6, cap).clip(0).astype(np.int32)
        state = jax_densify.add_densification_stats(
            state, jnp.asarray(g), jnp.asarray(radii), 48, 32)
        densify.add_densification_stats(model, torch.tensor(g[:n]),
                                        torch.tensor(radii[:n]), 48, 32)
    _assert_state(model, state)
    assert float(model.denom.max()) > 0


def _densify_fixture(seed=2):
    """A JAX state with statistics that select clones and splits, low
    opacities that prune, and non-zero Adam moments; then the same state
    bridged to the port."""
    state, _, _ = _jax_state(seed=seed)
    rng = np.random.default_rng(seed)
    cap, n = state.capacity, int(state.n_alive)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["scaling"][:n] = np.log(rng.uniform(0.005, 0.08, (n, 3)))
    params["rotation"][:n] = rng.normal(size=(n, 4))
    params["opacity"][:n, 0] = rng.uniform(-6.0, 2.0, n)
    accum = np.zeros(cap, np.float32)
    denom = np.zeros(cap, np.float32)
    accum[:n] = rng.uniform(0, 4e-4, n) * 3
    denom[:n] = rng.integers(0, 4, n)
    max_r = np.zeros(cap, np.float32)
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


@pytest.mark.parametrize("max_screen_size", [0, 20])
def test_densify_and_prune_matches_jax(max_screen_size):
    """Clones, splits (with the JAX draw handed over) and prunes, index by
    index: parameters within rtol 1e-6, Adam moments moved with their rows
    and zero on appended rows, statistics zeroed."""
    state, jadam = _densify_fixture()
    port = gm.from_jax_state(state, jadam, device="cpu")
    n, cap = int(state.n_alive), state.capacity
    key = jax.random.PRNGKey(11)
    res = jax_densify.densify_and_prune(
        state, jadam, key, 0.0002, 0.005, 5.0,
        max_screen_size=max_screen_size, percent_dense=0.01)
    assert int(res.appended) == int(res.requested)   # nothing dropped
    draws = []
    for _ in range(2):       # the draws of `densify.py:107-109`
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (cap, 3)))[:n])
    out = densify.densify_and_prune(
        port.model, port.adam, 0.0002, 0.005, 5.0,
        max_screen_size=max_screen_size, percent_dense=0.01,
        noise=torch.tensor(np.stack(draws)))
    assert out.cloned > 0 and out.split > 0 and out.pruned > out.split
    _assert_state(port.model, res.state)
    _assert_adam(port.adam, res.opt_state, int(res.state.n_alive))


def test_reset_opacity_matches_jax():
    state, jadam = _densify_fixture(seed=4)
    port = gm.from_jax_state(state, jadam, device="cpu")
    jstate, jadam2 = jax_densify.reset_opacity(state, jadam)
    densify.reset_opacity(port.model, port.adam)
    _assert_state(port.model, jstate)
    _assert_adam(port.adam, jadam2, int(state.n_alive))
    assert float(port.adam.m["opacity"].abs().max()) == 0.0


def test_create_from_pcd_matches():
    """Scale init against a numpy brute-force 3-NN (300 points, rtol 1e-5:
    the port takes differences, numpy too); the whole model against the
    JAX `create_from_pcd` where its windowed search is exhaustive (60
    points ≤ 2·window + 1)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    want = np.maximum(np.sort(d2, 1)[:, :3].mean(1), 1e-7)
    got = dist2_for_scale_init(torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)

    state, pts60, cols60 = _jax_state(n=60)
    model = gm.create_from_pcd(pts60, cols60, n_images=2, sh_degree=1,
                               device="cpu")
    _assert_state(model, state, rtol=1e-6)
    np.testing.assert_array_equal(model.exposure.numpy(),
                                  np.asarray(state.exposure))


def _train_fixture(width=48, height=48, n=160, seed=3):
    """A JAX state of Gaussians in front of 3 orbit cameras with random
    targets, and the lgdwt step config at a 16-px patch."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=3, sh_degree=1,
                                   capacity=256)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["features_rest"][:n] = rng.normal(size=(n, 3, 3)) * 0.2
    params["opacity"][:n, 0] = rng.uniform(-2.0, 1.0, n)
    params["scaling"][:n] = np.log(rng.uniform(0.03, 0.12, (n, 3)))
    params["rotation"][:n] = rng.normal(size=(n, 4))
    state = state._replace(params={k: jnp.asarray(v)
                                   for k, v in params.items()})
    cams = testing.make_orbit_cameras(3, radius=3.0, width=width,
                                      height_px=height)
    for c in cams:
        c.image = rng.random((height, width, 3)).astype(np.float32)
        c.alpha_mask = np.ones((height, width), np.float32)
    kw = dict(width=width, height=height, sh_degree=1, lambda_dssim=0.2,
              dwt_enable=True, patch_dwt_enable=True, patch_size=16)
    return state, cams, kw


def test_train_step_loss_and_grads_match_jax():
    """One lgdwt step: loss, DWT running mean, every parameter gradient and
    the view-space (2-D mean) gradient before the optimizer, against
    jax.grad of the JAX step's loss (its XLA tiled path on the CPU,
    `max_per_tile` above the deepest tile). Loss rtol 1e-5; gradients atol
    1e-4 of the largest (the JAX path differentiates the blend scan, the
    port runs the analytic backward)."""
    state, cams, kw = _train_fixture()
    n = int(state.n_alive)
    cam_idx, active, running = 1, 1, 1.3
    jcfg = jax_step.StepConfig(raster=RasterConfig(
        max_pairs=1 << 15, max_per_tile=1024, tile_batch=16), **kw)
    bank = jax_step.CameraBank.from_cameras(cams)
    band = jax_step.sh_band_mask(active, 1)

    def loss_fn(params, offset):
        p = dict(params)
        p["features_rest"] = params["features_rest"] * band[1:][None]
        loss, _, new_running = jax_step.view_losses(
            p, state.alive.astype(jnp.float32), state.exposure[cam_idx],
            bank.camera(cam_idx), bank.gt[cam_idx], bank.alpha_mask[cam_idx],
            bank.invdepth[cam_idx], bank.depth_mask[cam_idx],
            bank.has_depth[cam_idx], jnp.zeros(3), 0.5,
            jnp.asarray(running), jcfg, offset)
        return loss, new_running

    (jloss, jrun), (jg, jg_off) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(
            state.params, jnp.zeros((state.capacity, 2)))
    model = gm.from_jax_state(state, device="cpu").model
    tbank = step.CameraBank.from_cameras(cams, device="cpu")
    sg = step.loss_and_grads(model, tbank, cam_idx, 0.5, active,
                             torch.zeros(3), torch.tensor(running),
                             step.StepConfig(**kw))
    assert abs(float(sg.loss) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(sg.new_running) - float(jrun)) <= 1e-5 * float(jrun)
    assert sg.metrics["n_pairs"] > 0
    for k in PARAMS:
        want = np.asarray(jg[k])[:n]
        got = sg.grads[k].numpy()
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                                   rtol=0, err_msg=k)
    want = np.asarray(jg_off)[:n]
    np.testing.assert_allclose(sg.viewspace_grad.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    assert float(sg.exposure_grad.abs().max()) == 0.0   # train_test_exp off

    # the whole step: Adam on those gradients, stats from the radii
    model = gm.from_jax_state(state, device="cpu").model
    adam, eadam = optim.init_adam(model.params()), \
        optim.init_exposure_adam(model.exposure)
    step.train_step(model, adam, eadam, torch.tensor(running), tbank,
                    cam_idx, {k: 1e-3 for k in PARAMS}, 0.0, 0.5, active,
                    torch.zeros(3), step.StepConfig(**kw))
    assert adam.step == eadam.step == 1
    assert int((model.denom > 0).sum()) == int((sg.radii > 0).sum()) > 0


def test_render_core_confidence_scales_gradients():
    """`render_core(confidence=c)` (FSGS, JAX `renderer.py:71-89`): the
    forward within 1e-5 of the unscaled one (p·c + p·(1 − c) rounds where
    p does not), every parameter's gradient c times the unscaled one
    (within 1e-5 of the largest)."""
    from sparse_view_3dgs_pack_tpu_torch.renderer import render_core
    state, cams, _ = _train_fixture(width=32, height=32, n=60)
    n = int(state.n_alive)
    cam = step.CameraBank.from_cameras(cams, device="cpu").camera(0)
    c = torch.tensor(np.random.default_rng(10).uniform(0.1, 1.0, n)
                     .astype(np.float32))
    outs = []
    for conf in (None, c):
        model = gm.from_jax_state(state, device="cpu").model
        res = render_core(model.params(), model.exposure[0], cam, 32, 32,
                          torch.zeros(3), 1, inference=False,
                          confidence=conf)
        ((res.render ** 2).mean() + res.expected_depth.mean()).backward()
        outs.append((res.render.detach(),
                     {k: v.grad for k, v in model.params().items()}))
    (r0, g0), (r1, g1) = outs
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), rtol=1e-5, atol=1e-6)
    for k in PARAMS:
        want = g0[k] * c.reshape((-1,) + (1,) * (g0[k].ndim - 1))
        assert float(want.abs().max()) > 0, k
        np.testing.assert_allclose(g1[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=k)


def test_train_step_marks_its_stages():
    """A profile of one step holds every `record_function` range the step
    is split by (what `chip_smoke.py` attributes device time to)."""
    from torch.profiler import ProfilerActivity, profile
    state, cams, kw = _train_fixture(width=32, height=32, n=40)
    model = gm.from_jax_state(state, device="cpu").model
    adam, eadam = optim.init_adam(model.params()), \
        optim.init_exposure_adam(model.exposure)
    bank = step.CameraBank.from_cameras(cams, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.train_step(model, adam, eadam, torch.ones(()), bank, 0,
                        {k: 1e-3 for k in PARAMS}, 0.0, 0.0, 1,
                        torch.zeros(3), step.StepConfig(**kw))
    names = {e.name for e in prof.events()}
    for stage in ("render/projection", "render/binning", "render/rasterize",
                  "step/losses", "step/backward", "step/adam", "step/stats"):
        assert stage in names, stage


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_entry_points_default_to_the_card():
    """Without `device`, the model and camera entry points ask for CUDA and
    raise on a machine without it: nothing falls back to the CPU."""
    pts = np.zeros((4, 3), np.float32)
    cam = testing.make_orbit_cameras(1, radius=3.0, width=8, height_px=8)
    for call in (lambda: gm.create_from_pcd(pts, pts, n_images=1),
                 lambda: step.CameraBank.from_cameras(cam)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
