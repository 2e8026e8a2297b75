"""Port parity for `parallel/` (view data parallelism over torch.distributed
and the band-parallel render) on the CPU: gloo ranks spawned by the
package's own launcher (`parallel/dp.py::launch`) with a file rendezvous in
`tmp_path`, against JAX `build_dp_train_step` on a 2-device CPU mesh (one
compile per module) and against the port's own single-process step; the
`Trainer` data-parallel path across densify events; the band render
against the port's single render (bitwise) and JAX's band render; the
render CLI's `--tile_parallel`."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_workers as workers
from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.ops.rasterize_tiles import RasterConfig
from sparse_view_3dgs_pack_tpu.parallel import dp as jax_dp
from sparse_view_3dgs_pack_tpu.parallel import tiles as jax_tiles
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train import step as jax_step
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.parallel import dp
from sparse_view_3dgs_pack_tpu_torch.parallel.tiles import \
    make_tile_parallel_render_fn
from sparse_view_3dgs_pack_tpu_torch.render import to_u8
from sparse_view_3dgs_pack_tpu_torch.renderer import render
from sparse_view_3dgs_pack_tpu_torch.train import densify
from torch_port import REPO, subprocess_env

N_VIEWS, SIZE = 8, 32
PARAMS = gm.PARAM_NAMES
STATS = gm.STAT_NAMES


def _fixture(n=120, seed=5):
    """A JAX state in front of 8 orbit cameras with random targets, and the
    inputs of one lgdwt step (both packages'): the port's numpy rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=N_VIEWS, sh_degree=1,
                                   capacity=128)
    params = {k: np.array(v) for k, v in state.params.items()}
    params["features_rest"][:n] = rng.normal(size=(n, 3, 3)) * 0.2
    params["opacity"][:n, 0] = rng.uniform(-2.0, 1.0, n)
    params["scaling"][:n] = np.log(rng.uniform(0.03, 0.12, (n, 3)))
    params["rotation"][:n] = rng.normal(size=(n, 4))
    state = state._replace(params={k: jnp.asarray(v)
                                   for k, v in params.items()})
    cams = testing.make_orbit_cameras(N_VIEWS, radius=3.0, width=SIZE,
                                      height_px=SIZE)
    for c in cams:
        c.image = rng.random((SIZE, SIZE, 3)).astype(np.float32)
        c.alpha_mask = np.ones((SIZE, SIZE), np.float32)
    cfg = dict(width=SIZE, height=SIZE, sh_degree=1, lambda_dssim=0.2,
               dwt_enable=True, patch_dwt_enable=True, patch_size=16)
    fixture = dict(params=params, n=n, exposure=np.array(state.exposure),
                   cams=cams, cfg=cfg, n_views=N_VIEWS, running=1.3,
                   lrs={k: 1e-3 for k in PARAMS}, exposure_lr=1e-3,
                   depth_weight=0.5, active=1)
    return state, fixture


def _dp_runs(tmp_path):
    """One step of B = 8 views: JAX's DP step on a 2-device mesh, the
    port's 2 gloo ranks × 4 views, and the port's one process × 8."""
    state, fixture = _fixture()
    mesh = jax_dp.make_mesh(2)
    jcfg = jax_step.StepConfig(raster=RasterConfig(
        max_pairs=1 << 14, max_per_tile=1024, tile_batch=16),
        **fixture["cfg"])
    bank = jax_step.CameraBank.from_cameras(fixture["cams"])
    batch = jax_dp.shard_batch(
        jax_dp.ViewBatch.gather(bank, list(range(N_VIEWS))), mesh)
    js = jax_dp.replicate(state, mesh)
    with mesh:
        jstate, jadam, _, jcarry, jmetrics = jax_dp.build_dp_train_step(
            jcfg, mesh)(
            js, jax_dp.replicate(jax_optim.init_adam(js.params), mesh),
            jax_dp.replicate(jax_optim.init_exposure_adam(js.exposure),
                             mesh),
            jax_step.StepCarry(dwt_running_mean=jnp.asarray(1.3)), batch,
            {k: jnp.asarray(1e-3) for k in js.params}, jnp.asarray(1e-3),
            jnp.asarray(0.5), jnp.asarray(1, jnp.int32), jnp.zeros(3))
    dp.launch(workers.dp_step_rank, ["cpu", "cpu"],
              str(tmp_path / "rendezvous"), args=(fixture, str(tmp_path)))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    one = workers.dp_step(fixture, list(range(N_VIEWS)))
    return (jstate, jadam, jcarry, jmetrics), ranks, one, fixture["n"]


def _close_to_largest(got, want, frac, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale,
                               err_msg=what)


@pytest.mark.timeout(600)
def test_dp_step_matches_jax_and_world_of_one(tmp_path):
    """One step of B = 8 views (one JAX compile), the port's 2 gloo ranks
    × 4 views against JAX's 2-device step over the same views:
    * the first Adam moments (0.1 × the mean's gradient) within 5e-5 of
      each group's largest (the bar of `test_torch_train.py`: JAX
      differentiates the blend scan, the port runs the analytic
      backward); both counters one step;
    * the densification statistics as JAX leaves them: each view's
      view-space gradient norm at 1/B of its single-step size (the
      gradient of the mean), summed over views, within 1e-5 of the
      largest; visible counts and max radii equal;
    * the DWT running mean (the mean of the per-view new means) and the
      metrics (means over views) within 1e-6 relative, `n_pairs` the
      max. SSIM of random targets is ~1e-3, a sum of cancelling terms,
      and one view's sits up to 2.4e-7 from JAX's
      (`tests/test_torch_losses.py`): metrics also pass within 1e-7;
    * the two ranks end bitwise equal, and equal the single process that
      takes all 8 views to f32 reduction order (the gradients summed
      4 + 4 across ranks, 8 in a row in one process)."""
    (jstate, jadam, jcarry, jmetrics), ranks, one, n = _dp_runs(tmp_path)
    got = ranks[0]
    assert int(jadam.step) == 1
    for k in PARAMS:
        _close_to_largest(got[f"m.{k}"], np.asarray(jadam.m[k])[:n], 5e-5,
                          f"m.{k}")
        _close_to_largest(got[k], np.asarray(jstate.params[k])[:n], 1e-6,
                          k)

    want = np.asarray(jstate.xyz_gradient_accum)[:n]
    _close_to_largest(got["xyz_gradient_accum"], want, 1e-5, "accum")
    np.testing.assert_array_equal(got["denom"], np.asarray(jstate.denom)[:n])
    assert got["denom"].max() > 1       # seen by several views
    np.testing.assert_array_equal(got["max_radii2d"],
                                  np.asarray(jstate.max_radii2d)[:n])
    np.testing.assert_allclose(got["running"],
                               float(jcarry.dwt_running_mean), rtol=1e-6)
    for k, v in jmetrics.items():
        if k == "n_pairs":
            assert int(got["metric.n_pairs"]) == int(v)
        else:
            np.testing.assert_allclose(got[f"metric.{k}"], float(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)

    for k in got:
        np.testing.assert_array_equal(got[k], ranks[1][k], err_msg=k)
    for k in one:
        if k.startswith("metric."):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, err_msg=k)
        elif np.abs(one[k]).max() > 0:
            _close_to_largest(got[k], one[k], 1e-6, k)
        else:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)


def test_add_densification_stats_batch_matches_jax():
    """Three batches of 4 views' view-space gradients and radii through
    `train/densify.py::add_densification_stats` (the statistic
    `dp_train_step` takes per view): the summed per-view norms, counts and
    max radii of JAX `add_densification_stats_batch`, index by index."""
    state, fixture = _fixture()
    n, cap = fixture["n"], state.capacity
    model = gm.from_jax_state(state, device="cpu").model
    rng = np.random.default_rng(2)
    for _ in range(3):
        go = rng.normal(size=(4, cap, 2)).astype(np.float32) * 1e-4
        radii = rng.integers(-3, 6, (4, cap)).clip(0).astype(np.int32)
        state = jax_dp.add_densification_stats_batch(
            state, jnp.asarray(go), jnp.asarray(radii), 48, 32)
        densify.add_densification_stats(model, torch.tensor(go[:, :n]),
                                        torch.tensor(radii[:, :n]), 48, 32)
    for k in STATS:
        np.testing.assert_allclose(getattr(model, k).numpy(),
                                   np.asarray(getattr(state, k))[:n],
                                   rtol=1e-6, atol=1e-12, err_msg=k)
    assert float(model.denom.max()) > 3


@pytest.mark.timeout(600)
def test_trainer_dp_learns_and_replicas_stay_equal(tmp_path):
    """The `Trainer` path of `--data_parallel` (JAX `test_parallel.py::
    test_trainer_dp_cli_path_reaches_single_device_psnr`): 8 views at 32 px,
    60 iterations with densify events at 20 and 40, two gloo ranks of one
    view each. It learns by more than 1 dB, ends within 0.5 dB of the
    single-process run, and the two replicas end bitwise equal."""
    iters = 60
    s0, s1, single = workers.train_psnr(iters)
    dp.launch(workers.trainer_rank, ["cpu", "cpu"],
              str(tmp_path / "rendezvous"), args=(iters, str(tmp_path)))
    r0, r1 = (dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2))
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    d0, d1 = r0["psnr"]
    assert int(r0["iteration"]) == iters
    assert r0["xyz"].shape[0] != 160, "no densify event changed the count"
    assert d1 > d0 + 1.0, (d0, d1)
    assert d1 >= s1 - 0.5, (s1, d1)
    assert s1 > s0


def _jax_cloud_state(w, h, seed=1, n=150):
    rng = np.random.default_rng(seed)
    return jax_gm.create_from_pcd(
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.random((n, 3)).astype(np.float32),
        n_images=1, sh_degree=1, capacity=256)


def _faint_state():
    """Large faint Gaussians (`tests/test_torch_cli.py::_model_dir`): their
    alpha ≥ 1/255 ellipse sits inside the 3σ square, so the port's 32×16
    inference tiles and JAX's 16×16 cover the same pixels."""
    cloud = testing.make_sh3_cloud(0, 300, extent=1.0,
                                   scale_range=(0.3, 0.5))
    cloud["opacity"][:] = np.random.default_rng(3).uniform(
        -4.0, -3.0, (300, 1)).astype(np.float32)
    f = cloud["features"]
    return gm.GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:],
                            cloud["scales"], cloud["quats"],
                            cloud["opacity"])


@pytest.mark.parametrize("w,h", [(64, 128), (64, 112)])
def test_band_render_is_the_single_render(w, h):
    """JAX's two fixtures (`tests/test_parallel.py`): 64×128 (8 tile rows)
    on 8 bands, and 112 px (7 rows) on 8 with an empty trailing band; the
    band render equals the single render bit for bit, image, alpha and both
    depths, at 2, 3 and 8 bands."""
    model = gm.from_jax_state(_jax_cloud_state(w, h), device="cpu").model
    cam = testing.make_orbit_cameras(1, radius=3.5, width=w,
                                     height_px=h)[0]
    bg = [0.2, 0.1, 0.4]
    ref = render(model, cam, bg)
    for n in (2, 3, 8):
        got = make_tile_parallel_render_fn(["cpu"] * n, w, h)(
            model, cam, bg, scaling_modifier=0.5)
        for f in ("render", "alpha", "depth", "expected_depth"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (n, f)
        assert 0 < got.n_pairs <= ref.n_pairs


def test_band_render_matches_jax_band_render(tmp_path):
    """The port's band render and JAX `make_tile_parallel_render_fn` on the
    8 virtual CPU devices (112 px, a padded band), one model (a PLY both
    load): within one uint8 level, the tolerance of
    `tests/test_torch_cli.py`, and the floats within 1e-5."""
    w, h = 64, 112
    ply = str(tmp_path / "point_cloud.ply")
    gm.save_ply(_faint_state(), ply)
    model = gm.load_ply(ply, sh_degree=3, device="cpu")
    state = jax_gm.load_ply(ply, sh_degree=3)
    cam = testing.make_orbit_cameras(1, radius=3.5, width=w,
                                     height_px=h)[0]
    bg = [0.2, 0.1, 0.4]
    want = jax_tiles.make_tile_parallel_render_fn(jax_dp.make_mesh(8), w,
                                                  h)(state, cam,
                                                     jnp.asarray(bg))
    got = make_tile_parallel_render_fn(["cpu"] * 8, w, h)(model, cam, bg)
    np.testing.assert_allclose(got.render.numpy(), np.asarray(want.render),
                               atol=1e-5)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               atol=1e-5)
    diff = np.abs(to_u8(got.render).astype(int)
                  - to_u8(torch.as_tensor(np.array(want.render)))
                  .astype(int))
    assert diff.max() <= 1


def test_resolve_data_parallel(capsys):
    """`--data_parallel` as JAX reads it: '', 'off' → 1; 'auto' → every
    card (1 on the CPU); an int as given on the CPU, clamped to the cards
    with JAX's warning."""
    assert dp.resolve_data_parallel("", "cpu") == 1
    assert dp.resolve_data_parallel("off", "cpu") == 1
    assert dp.resolve_data_parallel("auto", "cpu") == 1
    assert dp.resolve_data_parallel("4", "cpu") == 4
    assert dp.resolve_data_parallel("0", "cpu") == 1
    assert dp.clamp_data_parallel(4, "cpu") == 4
    n_dev = torch.cuda.device_count()
    assert dp.clamp_data_parallel(n_dev + 1, "cuda") == n_dev
    assert (f"[dp] WARNING: --data_parallel {n_dev + 1} > {n_dev} devices; "
            f"clamping") in capsys.readouterr().out


@pytest.mark.timeout(600)
def test_render_cli_tile_parallel_writes_the_same_pngs(tmp_path):
    """`render --tile_parallel 8 --device cpu` renders 8 bands a frame and
    writes the PNGs of the plain render; `--tile_parallel -1` on the CPU
    (one device) says it renders single-device, as the JAX CLI does."""
    from argparse import Namespace
    from sparse_view_3dgs_pack_tpu_torch import config
    scene = jax_testing.write_blender_scene(str(tmp_path / "scene"),
                                            n_train=2, n_test=1, width=40)
    model = str(tmp_path / "model")
    gm.save_ply(_faint_state(), os.path.join(
        model, "point_cloud", "iteration_7", "point_cloud.ply"))
    config.write_cfg_args(model, Namespace(
        sh_degree=3, source_path=scene, model_path=model, images="images",
        depths="", resolution=-1, white_background=False,
        train_test_exp=False, data_device="cpu", eval=True, n_views=0,
        point_cloud_type="dense"))
    outs = {}
    for flag in ("0", "8", "-1"):
        proc = subprocess.run(
            [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.render",
             "-m", model, "--device", "cpu", "--tile_parallel", flag],
            cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[flag] = proc.stdout
        renders = {}
        for split in ("train", "test"):
            d = os.path.join(model, split, "ours_7", "renders")
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name), "rb") as f:
                    renders[(split, name)] = f.read()
        outs[flag + "png"] = renders
    assert "band-sharded rendering over 8 devices" in outs["8"]
    assert "only 1 device(s) available, rendering single-device" in outs["-1"]
    assert "tile_parallel:" not in outs["0"]
    assert len(outs["0png"]) == 3
    assert outs["8png"] == outs["0png"] == outs["-1png"]
