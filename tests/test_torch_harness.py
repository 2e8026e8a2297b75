"""The port's `gs_benchmark` harness (`benchmark/`) against the JAX one,
mirroring `tests/test_harness.py`: the dry run, `${...}` interpolation,
`build_cli_args`, the tables, `--resume` with the stages stubbed, the
preprocessing hook; the same config through both packages' `build_runs`
and `BenchTables`; the `-m` module entries and the `device` passthrough;
and the harness end to end on the CPU (a 32 px Blender scene, one `3dgs`
model, 20 iterations through the port's train, render and metrics CLIs)."""

import csv
import json
import logging
import math
import os
import sys

import pytest
import yaml

from sparse_view_3dgs_pack_tpu.benchmark import bench_tables as jax_tables
from sparse_view_3dgs_pack_tpu.benchmark import benchmark as jax_bm
from sparse_view_3dgs_pack_tpu.benchmark import \
    preprocess_handler as jax_pre
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.benchmark import bench_tables
from sparse_view_3dgs_pack_tpu_torch.benchmark import benchmark as bm
from sparse_view_3dgs_pack_tpu_torch.benchmark import cli
from sparse_view_3dgs_pack_tpu_torch.benchmark import preprocess_handler
from torch_port import REPO

PORT = "sparse_view_3dgs_pack_tpu_torch"
ARG_MAP = {k: k for k in (
    "source_path", "model_path", "sh_degree", "iterations", "test_iterations",
    "save_iterations", "eval", "quiet", "disable_viewer", "device")}


def _config(tmp_path, scene_dir, iters=20, module_entries=False, **args):
    """The JAX test's config (`tests/test_harness.py::_write_config`): one
    `3dgs` model on one scene, script entries, or the port's CLIs as
    module entries."""
    if module_entries:
        entries = {"entry": f"-m {PORT}.train",
                   "render_entry": f"-m {PORT}.render",
                   "metrics_entry": f"-m {PORT}.metrics"}
    else:
        entries = {"entry": "./train.py", "render_entry": "./render.py",
                   "metrics_entry": "./metrics.py"}
    return {
        "defaults": {
            "env": {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
            "common_args": {"disable_viewer": True, "quiet": True},
            "dataset_root": str(tmp_path / "data"),
            "out_root": str(tmp_path / "bench_runs"),
            "seeds": [42],
            "run_render": True,
            "run_metrics": True,
            "run_desc": "test",
        },
        "scenes": [{"name": "synth", "source_path": scene_dir}],
        "models": [{
            "name": "3dgs", "repo_dir": REPO, **entries, "method": "3dgs",
            "arg_map": dict(ARG_MAP),
            "args": {"iterations": iters, "sh_degree": 1,
                     "test_iterations": [iters], "save_iterations": [iters],
                     "eval": False, **args},
        }],
        "grid": {},
        "overrides": {},
    }


def _write(tmp_path, cfg, name="config.yaml"):
    path = tmp_path / name
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _resolved(cfg):
    return bm.resolve_refs(cfg, {"defaults": cfg["defaults"], "scenes": {}})


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench_scene"))
    cloud = testing.make_gaussian_cloud(7, 300, extent=0.9,
                                        scale_range=(0.05, 0.15))
    return testing.write_blender_scene(root, n_train=3, n_test=1, width=32,
                                       cloud=cloud, init_points=150)


def test_yaml_resolution_and_dry_run(tmp_path, scene_dir, capsys):
    """The dry run prints the JAX harness's run tags and, for script
    entries, its commands, through `cli.main runall`."""
    cfg_path = _write(tmp_path, _config(tmp_path, scene_dir))
    assert cli.main(["runall", "-c", cfg_path, "--dry"]) == 0
    out = capsys.readouterr().out
    assert "synth__3dgs__sh1__it20__seed42" in out
    assert "--method 3dgs" in out
    assert "--iterations 20" in out
    jax_bm.main(["-c", cfg_path, "--dry"])
    jax_out = capsys.readouterr().out
    assert [l for l in out.splitlines() if l.startswith(("==>", "CMD"))] == \
        [l for l in jax_out.splitlines() if l.startswith(("==>", "CMD"))]


def test_cli_help(capsys):
    assert cli.main(["-h"]) == 0
    assert "gs_benchmark_torch runall" in capsys.readouterr().out


@pytest.mark.parametrize("module", [bm, jax_bm], ids=["port", "jax"])
def test_ref_interpolation(module):
    ctx = {"defaults": {"dataset_root": "/data", "n": 3}}
    obj = {"a": "${defaults.dataset_root}/fern", "b": ["x${defaults.n}"]}
    out = module.resolve_refs(obj, ctx)
    assert out["a"] == "/data/fern"
    assert out["b"] == ["x3"]
    merged = module.deep_merge({"a": 1, "c": {"x": 1}},
                               {"b": 2, "c": {"y": 2}})
    assert merged == {"a": 1, "b": 2, "c": {"x": 1, "y": 2}}
    assert module.deep_merge({"a": 1}, {"a": None}) == {"a": 1}


@pytest.mark.parametrize("module", [bm, jax_bm], ids=["port", "jax"])
def test_build_cli_args(module):
    arg_map = {"iterations": "iterations", "eval": "eval",
               "test_iterations": "test_iterations", "quiet": "quiet"}
    flat = {"iterations": 100, "eval": True, "test_iterations": [5, 10],
            "quiet": False, "seed": 42}
    cli_args = module.build_cli_args(arg_map, flat)
    assert cli_args == ["--iterations", "100", "--eval",
                        "--test_iterations", "5", "10"]


def test_pure_helpers_match_jax():
    """slug, flatten_repo_args, as_namespace_string and expand_grid give
    the JAX harness's results on the same inputs."""
    for s in ("Fern Scene", "  a//b__c  ", "", "TPU-benchmark v2"):
        assert bm.slug(s) == jax_bm.slug(s)
    nested = {"model": {"sh_degree": 3, "eval": True}, "iterations": 7,
              "opt": {"lr": 0.1}}
    assert bm.flatten_repo_args(nested) == jax_bm.flatten_repo_args(nested)
    flat = {"a": 1, "b": "x", "c": [1, 2], "d": None, "e": True}
    for keep in (None, {"a", "c"}):
        assert bm.as_namespace_string(flat, keep) == \
            jax_bm.as_namespace_string(flat, keep)
    grid = {"iterations": [10, 20], "sh_degree": [0, 3], "seeds": [[1, 2]]}
    for g in ({}, grid):
        assert bm.expand_grid(g) == jax_bm.expand_grid(g)


def test_build_runs_matches_jax(tmp_path, scene_dir):
    """One config with script entries, a grid, seeds, an override and a
    pre-written `cfg_args` through both `build_runs`: the same tags,
    commands, paths and `cfg_args` files."""
    cfg = _config(tmp_path, scene_dir)
    cfg["models"][0]["needs_cfg_args_file"] = True
    cfg["models"].append(dict(cfg["models"][0], name="lgdwt",
                              method="lgdwt"))
    cfg["grid"] = {"sh_degree": [0, 3], "seeds": [[1, 2]]}
    cfg["overrides"] = {"lgdwt": {"synth": {"args": {"iterations": 7}}}}
    out = {}
    for name, module in (("port", bm), ("jax", jax_bm)):
        root = tmp_path / name
        root.mkdir()
        runs = module.build_runs(_resolved(cfg), root, sys.executable)
        cfg_args = {}
        for r in runs:
            with open(os.path.join(r["args_flat"]["model_path"],
                                   "cfg_args")) as f:
                cfg_args[r["tag"]] = f.read().replace(str(root), "<root>")
        out[name] = ([(r["tag"], [a.replace(str(root), "<root>")
                                  for a in r["cmd"]], r["seed"])
                      for r in runs], cfg_args)
    assert len(out["port"][0]) == 2 * 2 * 2
    assert out["port"] == out["jax"]
    assert "synth__lgdwt__sh3__it7__seed2" in out["port"][1]


def test_default_config_runs_the_port_modules(tmp_path, scene_dir, capsys):
    """The port's default config (`-c` omitted) builds the JAX default
    config's run tags for the same scenes, with module commands
    `python -m sparse_view_3dgs_pack_tpu_torch.train|render|metrics` and
    the same train flags after the entry."""
    runs = {}
    for name, module, path in (("port", bm, bm.DEFAULT_CONFIG),
                               ("jax", jax_bm,
                                os.path.join(REPO, "config.yaml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        cfg["scenes"] = [{"name": "synth", "source_path": scene_dir}]
        root = tmp_path / name
        root.mkdir()
        runs[name] = module.build_runs(_resolved(cfg), root, "python")
    assert [r["tag"] for r in runs["port"]] == [r["tag"] for r in runs["jax"]]
    assert [r["model"] for r in runs["port"]] == \
        ["3dgs", "lgdwt", "fsgs", "dngaussian"]
    for p, j in zip(runs["port"], runs["jax"]):
        assert p["cmd"][:3] == ["python", "-m", f"{PORT}.train"]
        assert j["cmd"][1].endswith("train.py")
        assert [a.replace(str(tmp_path / "port"), "")
                for a in p["cmd"][3:]] == \
            [a.replace(str(tmp_path / "jax"), "") for a in j["cmd"][2:]]

    cfg = yaml.safe_load(open(bm.DEFAULT_CONFIG))
    cfg["scenes"] = [{"name": "synth", "source_path": scene_dir}]
    cfg["defaults"]["out_root"] = str(tmp_path / "runs")
    cfg_path = _write(tmp_path, cfg)
    bm.main(["-c", cfg_path, "--dry"])
    out = capsys.readouterr().out
    assert out.count(f" -m {PORT}.train --method ") == 4
    assert "synth__dngaussian__sh3__it1000__seed42" in out


def _stub_stages(monkeypatch):
    calls = []
    monkeypatch.setattr(bm, "_subprocess_stage",
                        lambda *a, **k: calls.append(a) or (0, 0.0))
    return calls


@pytest.mark.parametrize("device", [None, "cpu"])
def test_module_entries_and_device(tmp_path, scene_dir, monkeypatch, device):
    """Module entries run as `python -m <module>` from `repo_dir`; a run's
    `device` reaches the train stage through `arg_map` and the render and
    metrics stages as `--device`; without one no stage gets the flag."""
    extra = {} if device is None else {"device": device}
    cfg = _resolved(_config(tmp_path, scene_dir, module_entries=True,
                            **extra))
    runs = bm.build_runs(cfg, tmp_path / "out", "py")
    calls = _stub_stages(monkeypatch)
    bm.execute_runs(runs, cfg, tmp_path / "out", "py")
    cmds = {label: cmd for cmd, cwd, _, _, label, _ in calls}
    assert sorted(cmds) == ["Metrics", "Render", "Train"]
    assert all(cwd == REPO for _, cwd, *_ in calls)
    assert cmds["Train"][:3] == ["py", "-m", f"{PORT}.train"]
    assert cmds["Render"][:3] == ["py", "-m", f"{PORT}.render"]
    assert cmds["Metrics"][:3] == ["py", "-m", f"{PORT}.metrics"]
    for cmd in cmds.values():
        if device is None:
            assert "--device" not in cmd
        else:
            assert cmd[cmd.index("--device") + 1] == device


@pytest.mark.parametrize("module", [bench_tables, jax_tables],
                         ids=["port", "jax"])
def test_bench_tables_export(tmp_path, module):
    rows = [
        {"tag": "a__m1", "scene": "a", "model": "m1", "seed": 1,
         "psnr": 20.0, "ssim": 0.8, "lpips": 0.3, "duration_sec": 10,
         "exit_code": 0},
        {"tag": "a__m2", "scene": "a", "model": "m2", "seed": 1,
         "psnr": 22.0, "ssim": 0.85, "lpips": 0.25, "duration_sec": 12,
         "exit_code": 0},
    ]
    out = module.BenchTables(rows).export(tmp_path)
    tex = (out / "psnr.tex").read_text()
    assert "m1" in tex and "m2" in tex
    assert "\\textbf{22.000}" in tex
    assert (out / "combined.tex").exists()


def test_bench_tables_tex_matches_jax(tmp_path):
    """The same rows (seeds, a missing cell, a proxy LPIPS backend) give
    byte-identical `.tex` files from both packages."""
    rows = []
    for scene in ("fern", "room"):
        for model, base in (("3dgs", 20.0), ("fsgs", 21.5), ("dng", 22.0)):
            for seed in (1, 2):
                if scene == "room" and model == "dng":
                    continue
                rows.append({
                    "tag": f"{scene}__{model}__{seed}", "scene": scene,
                    "model": model, "seed": seed,
                    "psnr": base + 0.25 * seed, "ssim": 0.8 + 0.01 * seed,
                    "lpips": None, "lpips_proxy": 0.3 - 0.01 * seed,
                    "lpips_backend": "random-features-proxy",
                    "duration_sec": 10.0 * seed, "exit_code": 0})
    tex = {}
    for name, module in (("port", bench_tables), ("jax", jax_tables)):
        out = module.BenchTables([dict(r) for r in rows]).export(
            tmp_path / name)
        tex[name] = {p.name: p.read_bytes() for p in sorted(
            out.glob("*.tex"))}
    assert sorted(tex["port"]) == ["combined.tex", "duration_sec.tex",
                                   "lpips.tex", "lpips_proxy.tex",
                                   "psnr.tex", "ssim.tex"]
    assert tex["port"] == tex["jax"]
    assert b"PROXY backend" in tex["port"]["lpips.tex"]


def test_resume_skips_completed_runs(tmp_path, scene_dir, monkeypatch):
    """--resume skips runs whose result.json shows a finished pipeline
    (metrics block present) without spawning any subprocess, and re-runs
    runs that only got through training, or whose training crashed."""
    cfg = _resolved(_config(tmp_path, scene_dir))
    out_root = tmp_path / "resume_out"
    out_root.mkdir()
    runs = bm.build_runs(cfg, out_root, sys.executable)
    assert len(runs) == 1
    done = {"exit_code": 0, "duration_sec": 1.0, "psnr": 30.0,
            "ssim": 0.9, "lpips": None}
    with open(runs[0]["result_path"], "w") as f:
        json.dump(done, f)

    calls = _stub_stages(monkeypatch)
    rows = bm.execute_runs(runs, cfg, out_root, sys.executable, resume=True)
    assert calls == []                      # nothing re-ran
    assert rows and rows[0]["psnr"] == 30.0  # summary row reloaded

    with open(runs[0]["result_path"], "w") as f:
        json.dump({"exit_code": 0, "duration_sec": 1.0}, f)
    bm.execute_runs(runs, cfg, out_root, sys.executable, resume=True)
    assert calls                             # train-only: re-ran

    calls.clear()
    with open(runs[0]["result_path"], "w") as f:
        json.dump({**done, "exit_code": 1, "psnr": None, "ssim": None}, f)
    bm.execute_runs(runs, cfg, out_root, sys.executable, resume=True)
    assert calls                             # failed run re-ran


@pytest.mark.parametrize("module", [preprocess_handler, jax_pre],
                         ids=["port", "jax"])
def test_preprocess_handler_compatibility(tmp_path, module, caplog):
    """The scene-layout gate of the preprocessing hook, and the warning
    for a missing few-shot dense init, which names the package's own
    `fewshot_colmap`."""
    blender = tmp_path / "b"
    (blender / "train").mkdir(parents=True)
    (blender / "transforms_train.json").write_text("{}")
    assert module.check_dataset_compatibility(str(blender))

    colmap = tmp_path / "c"
    (colmap / "images").mkdir(parents=True)
    assert not module.check_dataset_compatibility(str(colmap))
    (colmap / "sparse").mkdir()
    assert module.check_dataset_compatibility(str(colmap))

    with pytest.raises(ValueError):
        module.handle_dataset_preprocessing(
            {}, {"source_path": str(tmp_path / "x")}, {})
    with caplog.at_level(logging.WARNING):
        out = module.handle_dataset_preprocessing(
            {"args": {"n_views": 3, "point_cloud_type": "dense"}},
            {"source_path": str(blender)}, {})
    assert out == str(blender)
    package = module.__name__.split(".")[0]
    assert f"python -m {package}.preprocessing.fewshot_colmap" in caplog.text


@pytest.mark.timeout(300)
def test_harness_end_to_end(tmp_path, scene_dir):
    """The port's harness trains, renders and scores the scene through the
    port's CLIs on the CPU (`device: cpu`): exit 0, `summary.csv`,
    `result.json` with the JAX key set, the renders, `results.json` and
    `tables/combined.tex`; the train log's PSNR is scraped when the run is
    not quiet."""
    cfg = _config(tmp_path, scene_dir, module_entries=True, device="cpu",
                  quiet=False)
    bm.main(["-c", _write(tmp_path, cfg)])
    run_dirs = list((tmp_path / "bench_runs").iterdir())
    assert len(run_dirs) == 1
    run_root = run_dirs[0]
    tag = "synth__3dgs__sh1__it20__seed42"
    with open(run_root / "summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["scene"], r["model"], r["tag"]) for r in rows] == \
        [("synth", "3dgs", tag)]
    with open(run_root / tag / "result.json") as f:
        result = json.load(f)
    assert result["exit_code"] == 0, result
    assert {"exit_code", "duration_sec", "psnr", "ssim", "lpips",
            "lpips_backend"} <= set(result)
    assert "lpips_proxy" in result or result["lpips"] is not None
    assert math.isfinite(result["psnr"]) and math.isfinite(result["ssim"])
    assert (run_root / "tables" / "combined.tex").exists()
    model_dir = run_root / tag / "model"
    renders = model_dir / "train" / "ours_20" / "renders"
    assert renders.exists() and len(list(renders.iterdir())) == 3
    with open(model_dir / "results.json") as f:
        assert json.load(f)["ours_20"]["PSNR"] == result["psnr"]
    log = (run_root / tag / "logs" / "train.log").read_text()
    assert "PSNR" in log and "Training complete" in log
