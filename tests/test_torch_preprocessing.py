"""The port's preprocessing tools against the JAX package's on the same
inputs: `testing.write_colmap_scene`, LLFF `poses_bounds.npy`, the
greenhouse TIFF pipeline (and its `nir/` band through the port's camera
loader), the few-shot pipeline without a COLMAP binary, the convert CLI,
`make_depth_scale`, `data_pipeline`'s stage routing and `full_eval`'s jobs
(mirroring `tests/test_preprocessing.py`)."""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image as PILImage

from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.preprocessing import \
    data_pipeline as jax_data_pipeline
from sparse_view_3dgs_pack_tpu.preprocessing import greenhouse as jax_gh
from sparse_view_3dgs_pack_tpu.preprocessing import llff_poses as jax_llff
from sparse_view_3dgs_pack_tpu.preprocessing import \
    make_depth_scale as jax_mds
from sparse_view_3dgs_pack_tpu_torch import convert, full_eval, testing
from sparse_view_3dgs_pack_tpu_torch.data import colmap
from sparse_view_3dgs_pack_tpu_torch.preprocessing import (data_pipeline,
                                                           greenhouse,
                                                           llff_poses,
                                                           make_depth_scale)
from sparse_view_3dgs_pack_tpu_torch.utils import image_io
import torch_port  # noqa: F401  (one intra-op thread)


def _tree(root):
    """relative path → bytes of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_write_colmap_scene_matches_jax(tmp_path):
    """The port's copy writes the JAX scene: the COLMAP binaries byte for
    byte, the images pixel for pixel."""
    port = testing.write_colmap_scene(str(tmp_path / "port"), n_train=5,
                                      n_points=70)
    ref = jax_testing.write_colmap_scene(str(tmp_path / "jax"), n_train=5,
                                         n_points=70)
    a, b = _tree(port), _tree(ref)
    assert sorted(a) == sorted(b)
    for name in a:
        if name.endswith(".png"):
            with PILImage.open(os.path.join(ref, name)) as im:
                np.testing.assert_array_equal(
                    image_io.read_image(os.path.join(port, name)),
                    np.asarray(im), name)
        else:
            assert a[name] == b[name], name


def test_llff_poses_match_jax(tmp_path):
    """`gen_poses`: (6, 17) rows, orthonormal rotations, the hwf column,
    ordered positive bounds, and the JAX result on the same scene."""
    scene = testing.write_colmap_scene(str(tmp_path / "port"), n_train=6,
                                       n_points=100)
    ref = jax_testing.write_colmap_scene(str(tmp_path / "jax"), n_train=6,
                                         n_points=100)
    assert llff_poses.gen_poses(scene) and jax_llff.gen_poses(ref)
    pb = np.load(os.path.join(scene, "poses_bounds.npy"))
    assert pb.shape == (6, 17)
    poses = pb[:, :15].reshape(-1, 3, 5)
    R = poses[0, :, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert poses[0, 0, 4] == 48 and poses[0, 1, 4] == 64
    assert (pb[:, 15] <= pb[:, 16]).all() and (pb[:, 15] > 0).all()
    np.testing.assert_array_equal(
        pb, np.load(os.path.join(ref, "poses_bounds.npy")))
    assert not llff_poses.gen_poses(str(tmp_path / "empty"))


def _tiffs(scene, n=2, cams=("Camera1",), seed=0):
    rng = np.random.default_rng(seed)
    for cam in cams:
        d = os.path.join(scene, "TIFF", cam)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = (rng.random((16, 20, 4)) * 255).astype(np.uint8)
            PILImage.fromarray(arr).save(os.path.join(d, f"img_{i}.tif"))


def test_greenhouse_pipeline_matches_jax(tmp_path):
    """`process_scene` on two cameras' 4-band TIFFs: the merged stack,
    the pseudo-RGB composites, the four band directories and `nir/`, the
    same files as the JAX pipeline writes from the same input, pixel for
    pixel."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _tiffs(port, cams=("Camera1", "Camera2"))
    shutil.copytree(port, ref)
    greenhouse.process_scene(port, "scene")
    jax_gh.process_scene(ref, "scene")
    a, b = _tree(port), _tree(ref)
    assert sorted(a) == sorted(b)
    assert len(os.listdir(os.path.join(port, "scene_rgb"))) == 4
    for band in ("R", "G", "RE", "NIR"):
        assert len(os.listdir(os.path.join(port, f"images_{band}"))) == 4
    assert sorted(os.listdir(os.path.join(port, "nir"))) == sorted(
        os.listdir(os.path.join(port, "images_NIR")))
    for name in a:
        if name.endswith(".png"):
            with PILImage.open(os.path.join(port, name)) as x, \
                    PILImage.open(os.path.join(ref, name)) as y:
                assert x.size == (20, 16), name
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              name)
        else:
            assert a[name] == b[name], name


def test_greenhouse_nir_feeds_the_port_camera_loader(tmp_path):
    """The greenhouse `nir/` directory beside `images/` (the pseudo-RGB
    composites under the same names) with a COLMAP model of those images:
    the port's Scene(use_nir=True) gives every camera its NIR band in
    [0, 1], the greenhouse band's pixels / 255."""
    from argparse import Namespace
    from sparse_view_3dgs_pack_tpu_torch.scene import Scene

    scene = str(tmp_path / "scene")
    _tiffs(scene, n=3)
    greenhouse.process_scene(scene, "scene")
    shutil.copytree(os.path.join(scene, "scene_rgb"),
                    os.path.join(scene, "images"))
    names = sorted(os.listdir(os.path.join(scene, "images")))
    sparse = os.path.join(scene, "sparse", "0")
    os.makedirs(sparse)
    colmap.write_cameras_binary(
        {1: colmap.Camera(1, "PINHOLE", 20, 16,
                          np.array([18.0, 18.0, 10.0, 8.0]))},
        os.path.join(sparse, "cameras.bin"))
    images = {}
    for i, name in enumerate(names):
        R, T = testing.look_at_rt((i * 0.2 - 0.2, 0.0, -3.0), (0, 0, 0),
                                  up=(0.0, -1.0, 0.0))
        images[i + 1] = colmap.Image(i + 1, colmap.rotmat2qvec(R.T), T, 1,
                                     name, np.zeros((0, 2)),
                                     np.zeros((0,), np.int64))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    rng = np.random.default_rng(1)
    colmap.write_points3D_binary(
        {i: colmap.Point3D(i, rng.uniform(-1, 1, 3),
                           np.array([100, 120, 140], np.uint8), 0.5,
                           np.array([1], np.int32), np.array([0], np.int32))
         for i in range(20)}, os.path.join(sparse, "points3D.bin"))
    out = tmp_path / "out"
    os.makedirs(out)
    args = Namespace(source_path=scene, model_path=str(out),
                     images="images", depths="", eval=False, resolution=-1,
                     white_background=False, train_test_exp=False,
                     n_views=0, point_cloud_type="sparse")
    cams = Scene(args, sh_degree=1, use_nir=True, shuffle=False,
                 device="cpu").getTrainCameras()
    assert [c.image_name for c in cams] == names
    for c in cams:
        with PILImage.open(os.path.join(scene, "images_NIR",
                                        c.image_name)) as im:
            want = np.asarray(im).astype(np.float32) / 255.0
        assert c.nir.shape == (16, 20)
        np.testing.assert_array_equal(c.nir, want)


def test_fewshot_requires_colmap(tmp_path):
    """Without a COLMAP binary the few-shot pipeline fails loudly."""
    if shutil.which("colmap"):
        pytest.skip("colmap available; behavior covered by real runs")
    from sparse_view_3dgs_pack_tpu_torch.preprocessing.fewshot_colmap \
        import run_fewshot_pipeline

    scene = testing.write_colmap_scene(str(tmp_path), n_train=6)
    with pytest.raises(FileNotFoundError):
        run_fewshot_pipeline(scene, 3)


def test_convert_cli_flags_route_like_the_root_cli(monkeypatch):
    """`python -m ...convert`: `--help` exits, and each flag set reaches
    `run_full_colmap` as the root `convert.py` passes it."""
    import convert as root_convert
    from sparse_view_3dgs_pack_tpu.preprocessing import full_colmap

    with pytest.raises(SystemExit):
        convert.main(["--help"])
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(convert, "run_full_colmap",
                        lambda *a, **k: calls["port"].append((a, k)))
    monkeypatch.setattr(full_colmap, "run_full_colmap",
                        lambda *a, **k: calls["jax"].append((a, k)))
    for argv in (["-s", "scn"],
                 ["-s", "scn", "--no_gpu", "--skip_matching", "--resize",
                  "--camera", "PINHOLE", "--colmap_executable", "/x/colmap"]):
        convert.main(argv)
        root_convert.main(argv)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert calls["port"][1] == (("scn", "input", "/x/colmap", "PINHOLE"),
                                dict(use_gpu=False, skip_matching=True,
                                     resize=True))


def _depth_scene(root):
    """COLMAP binaries of one camera at the origin looking +z over 60
    points, and a 16-bit mono inverse-depth PNG equal to
    (1/z − 0.05) / 0.5 at their pixels."""
    import cv2

    rng = np.random.default_rng(5)
    W, H, fx, n = 64, 48, 70.0, 60
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    colmap.write_cameras_binary(
        {1: colmap.Camera(1, "PINHOLE", W, H,
                          np.array([fx, fx, W / 2, H / 2]))},
        os.path.join(sparse, "cameras.bin"))
    z = rng.uniform(2.0, 5.0, n)
    u = rng.uniform(6, W - 6, n)
    v = rng.uniform(6, H - 6, n)
    xyz = np.stack([(u - W / 2) * z / fx, (v - H / 2) * z / fx, z], axis=1)
    pids = np.arange(1, n + 1, dtype=np.int64)
    colmap.write_images_binary(
        {1: colmap.Image(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1,
                         "view.png", np.stack([u, v], axis=1), pids)},
        os.path.join(sparse, "images.bin"))
    colmap.write_points3D_binary(
        {int(pid): colmap.Point3D(int(pid), xyz[i], np.zeros(3, np.uint8),
                                  0.1, np.array([1], np.int32),
                                  np.array([i], np.int32))
         for i, pid in enumerate(pids)}, os.path.join(sparse,
                                                      "points3D.bin"))
    mono = np.zeros((H, W), np.float32)
    mono[np.round(v).astype(int), np.round(u).astype(int)] = \
        (1.0 / z - 0.05) / 0.5
    os.makedirs(os.path.join(root, "depths"))
    cv2.imwrite(os.path.join(root, "depths", "view.png"),
                (mono * (2 ** 16)).astype(np.uint16))


def test_make_depth_scale_recovers_affine_like_jax(tmp_path):
    """`make_depth_scale` recovers the affine map (scale 0.5, offset 0.05)
    within 5e-3, and writes the JAX function's `depth_params.json` on a
    copy of the same scene."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _depth_scene(port)
    shutil.copytree(port, ref)
    out = make_depth_scale.make_depth_scale(port, "depths")
    got = json.load(open(out))
    assert abs(got["view"]["scale"] - 0.5) < 5e-3
    assert abs(got["view"]["offset"] - 0.05) < 5e-3
    assert got == json.load(open(jax_mds.make_depth_scale(ref, "depths")))


def _routing(dp, monkeypatch, tmp_path):
    """Every stage run of `dp.main` on a fresh scene directory: the calls
    it makes to the three pipeline pieces, and the SystemExit of part2
    without --n_views."""
    calls = []
    monkeypatch.setattr(dp, "run_full_colmap",
                        lambda *a, **k: calls.append(("full", a)))
    monkeypatch.setattr(dp, "gen_poses",
                        lambda *a, **k: calls.append(("poses", a)))
    monkeypatch.setattr(dp, "run_fewshot_pipeline",
                        lambda *a, **k: calls.append(("fewshot", a)))
    scn = tmp_path / "scn"
    scn.mkdir()
    base = ["--base_path", str(tmp_path), "--scene", "scn"]
    dp.main(base + ["--stage", "part1"])
    with pytest.raises(SystemExit):
        dp.main(base + ["--stage", "part2"])
    dp.main(base + ["--stage", "part2", "--n_views", "3",
                    "--dataset", "mipnerf360"])
    dp.main(base + ["--stage", "part2", "--n_views", "3",
                    "--dataset", "llff"])
    (scn / "images").mkdir()
    (scn / "sparse" / "0").mkdir(parents=True)
    (scn / "poses_bounds.npy").write_bytes(b"")
    dp.main(base + ["--stage", "full", "--n_views", "4"])
    return calls


def test_data_pipeline_stage_routing_matches_jax(monkeypatch, tmp_path):
    """--stage routes to the right pieces with the dataset-aware feature
    caps (16384 for mipnerf360, 32768 for llff), skips the reconstruction
    whose outputs exist, and makes the JAX module's calls."""
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = _routing(data_pipeline, monkeypatch, tmp_path / "port")
    want = _routing(jax_data_pipeline, monkeypatch, tmp_path / "jax")
    scn = str(tmp_path / "port" / "scn")
    assert [c[0] for c in got] == ["full", "poses", "fewshot", "fewshot",
                                   "fewshot"]
    assert got[2] == ("fewshot", (scn, 3, "colmap", 16384, "mipnerf360", 1))
    assert got[3][1][3] == 32768
    assert got[4] == ("fewshot", (scn, 4, "colmap", 32768, None, 1))
    jscn = str(tmp_path / "jax" / "scn")
    assert [(k, tuple(scn if x == jscn else x for x in a))
            for k, a in want] == got


def _full_eval_calls(module, monkeypatch, argv):
    calls = []
    monkeypatch.setattr(module, "run", lambda cmd: calls.append(cmd))
    module.main(argv)
    return calls


def test_full_eval_builds_expected_jobs(monkeypatch, tmp_path):
    """full_eval drives train/render/metrics per scene with the reference's
    per-set resolution flags (images_4 for m360 outdoor, images_2 indoor,
    none for tat/db) through the port's module CLIs, and makes the root
    `full_eval.py`'s calls with `-m <module>` in place of each script."""
    import full_eval as jax_full_eval

    argv = ["-m360", str(tmp_path / "m360"), "-tat", str(tmp_path / "tat"),
            "--output_path", str(tmp_path / "out"), "--method", "3dgs"]
    calls = _full_eval_calls(full_eval, monkeypatch, argv)
    pkg = "sparse_view_3dgs_pack_tpu_torch"

    def stage(name):
        return [c for c in calls if c[1:3] == ["-m", f"{pkg}.{name}"]]

    trains, renders, metrics = stage("train"), stage("render"), \
        stage("metrics")
    assert len(trains) == len(renders) == 9 + 2   # 9 m360 + 2 tat scenes
    assert len(metrics) == 1 and len(metrics[0]) >= 3 + 1 + 11

    def flags(scene):
        cmd = next(c for c in trains if any(scene in a for a in c))
        return cmd[cmd.index("-i") + 1] if "-i" in cmd else None

    assert flags("bicycle") == "images_4"        # outdoor
    assert flags("bonsai") == "images_2"         # indoor
    assert flags("truck") is None                # tanks&temples: full res
    assert all("--method" in c and "3dgs" in c for c in trains)

    want = _full_eval_calls(jax_full_eval, monkeypatch, argv)
    scripts = {f"{name}.py": ["-m", f"{pkg}.{name}"]
               for name in ("train", "render", "metrics")}
    assert calls == [[c[0], *scripts[os.path.basename(c[1])], *c[2:]]
                     for c in want]

    # skip flags suppress their stages
    calls = _full_eval_calls(full_eval, monkeypatch, [
        "-tat", str(tmp_path / "tat"), "--skip_training", "--skip_metrics",
        "--output_path", str(tmp_path / "o2")])
    assert calls and all(c[1:3] == ["-m", f"{pkg}.render"] for c in calls)
