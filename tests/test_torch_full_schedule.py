"""The port's reference-schedule run of the main path
(`sparse_view_3dgs_pack_tpu_torch.full_schedule`) against
`scripts/tpu_full_schedule.py`: the scene's cloud, cameras, transforms and
`points3d.ply` bitwise equal to what the JAX package's generators and the
same draws give, its images to JAX's dense render, and the module end to
end at 48 px on the CPU."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.data.ply import \
    store_point_cloud as jax_store_point_cloud
from sparse_view_3dgs_pack_tpu.ops.rasterize_ref import \
    rasterize_dense as jax_rasterize_dense
from sparse_view_3dgs_pack_tpu_torch import full_schedule, testing
from torch_port import REPO, project_both, subprocess_env

SIZE, N_GAUSS, N_INIT = 48, 1500, 200
# the JAX dense render against the port's plain tiled one: float32 sums in
# another order (tests/test_torch_raster.py)
IMAGE_TOL = 1e-5


def test_scene_matches_the_jax_script(tmp_path):
    """Cloud and cameras from the JAX package's generators, the start
    points from the same `default_rng(0)` draws (the PLY written by the
    JAX package's `store_point_cloud`, byte for byte), and the transforms
    with the script's `c2w[:3, 1:3] *= -1`."""
    cloud, cams, xyz, rgb = full_schedule.scene_inputs(SIZE, N_GAUSS, N_INIT)
    jcloud = jax_testing.make_gaussian_cloud(11, N_GAUSS, extent=1.2,
                                             scale_range=(0.002, 0.02))
    jcams = jax_testing.make_orbit_cameras(24, radius=3.5, width=SIZE,
                                           height_px=SIZE)
    assert set(cloud) == set(jcloud)
    for k in cloud:
        np.testing.assert_array_equal(cloud[k], np.asarray(jcloud[k]), k)
    assert len(cams) == len(jcams) == 24
    for c, j in zip(cams, jcams):
        np.testing.assert_array_equal(c.R, j.R)
        np.testing.assert_array_equal(c.T, j.T)
        assert (c.fovx, c.fovy, c.width, c.height) == (j.fovx, j.fovy,
                                                       j.width, j.height)

    scene = str(tmp_path / "scene")
    full_schedule.build_scene(scene, SIZE, "cpu", N_GAUSS, N_INIT)
    rng = np.random.default_rng(0)
    sel = rng.choice(N_GAUSS, N_INIT, replace=False)
    want = str(tmp_path / "jax.ply")
    jax_store_point_cloud(want, jcloud["xyz"][sel]
                          + rng.normal(0, 0.02, (N_INIT, 3)),
                          rng.random((N_INIT, 3)))
    with open(want, "rb") as a, \
            open(os.path.join(scene, "points3d.ply"), "rb") as b:
        assert a.read() == b.read()
    frames = []
    for i, cam in enumerate(jcams):
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(scene, f"transforms_{split}.json")) as f:
            assert json.load(f) == {"camera_angle_x": jcams[0].fovx,
                                    "frames": frames}
    assert sorted(os.listdir(os.path.join(scene, "train"))) == sorted(
        f"r_{i}.png" for i in range(24))


def test_scene_images_match_jax_dense_render():
    """The ground-truth renders (SH 0, black background, clipped) against
    JAX's dense render within IMAGE_TOL, on large faint Gaussians whose
    α ≥ 1/255 ellipse lies inside the 3σ square (so the port's 32×16
    inference tiles and the dense render's 16×16 cull cover the same
    pixels, tests/test_torch_cli.py)."""
    cloud = testing.make_gaussian_cloud(5, 300, extent=1.0,
                                        scale_range=(0.3, 0.5))
    cloud["opacity"][:] = np.random.default_rng(3).uniform(
        -4.0, -3.0, (300, 1)).astype(np.float32)
    cams = testing.make_orbit_cameras(3, radius=3.5, width=SIZE,
                                      height_px=SIZE)
    got = full_schedule.render_views(cloud, cams, "cpu")
    for cam, img in zip(cams, got):
        jproj, _ = project_both(cloud, cam)
        want = np.clip(np.asarray(jax_rasterize_dense(
            jproj, SIZE, SIZE, jnp.zeros(3)).color), 0.0, 1.0)
        assert img.shape == want.shape == (SIZE, SIZE, 3)
        assert want.max() > 0.05
        np.testing.assert_allclose(img, want, atol=IMAGE_TOL, rtol=0)


def test_full_schedule_runs_end_to_end_on_the_cpu(tmp_path):
    """`python -m sparse_view_3dgs_pack_tpu_torch.full_schedule` at 48 px,
    200 iterations with densify events: every stage exits 0, summary.json
    holds the eval curve, it/s and results.json beside the JAX record, and
    the test PSNR rises from the start model's."""
    work = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.full_schedule",
         work, "--size", str(SIZE), "--n_gauss", str(N_GAUSS), "--n_init",
         str(N_INIT), "--iterations", "200", "--test_iterations", "100",
         "200", "--device", "cpu", "--patch_size", "16",
         "--densify_from_iter", "50", "--densification_interval", "50"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(work, "summary.json")) as f:
        s = json.load(f)
    assert s["ok"]
    assert [k for k, v in s["stages"].items() if v["rc"] == 0] == [
        "scene", "train", "render", "metrics"]
    assert [r["iteration"] for r in s["curve"]] == [100, 200]
    assert s["curve"][-1]["gaussians"] != N_INIT
    assert s["its_per_s"] > 0
    assert s["jax"]["results"] == {"PSNR": 34.45, "SSIM": 0.964}
    assert s["results"]["PSNR"] > s["test_psnr_iteration_0"] + 1.0
    # the metrics CLI scores the uint8 PNGs, the eval line the float renders
    assert abs(s["results"]["PSNR"] - s["curve"][-1]["psnr"]) < 0.1
