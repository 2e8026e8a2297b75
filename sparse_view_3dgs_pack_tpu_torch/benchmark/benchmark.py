"""fs3dgs-compatible benchmark harness.

Same contracts as the reference `fs3dgs_benchmark/benchmark.py:135-474`:
YAML config with `defaults / scenes / models / grid / overrides`, `${a.b.c}`
interpolation, per-model `arg_map` flag whitelists, optional pre-written
`cfg_args`, run tags `scene__model__shX__itY__seedZ`, train/render/metrics
subprocesses with per-stage logs, PSNR log-scrape, results.json merge,
`summary.csv` and LaTeX/PNG tables.

The port's copy of `sparse_view_3dgs_pack_tpu/benchmark/benchmark.py`,
with two changes:

- **Module entries.** An `entry`, `render_entry` or `metrics_entry` of the
  form `-m <module>` runs as `[python, "-m", <module>]` from `repo_dir`
  (the port's CLIs are modules: `-m sparse_view_3dgs_pack_tpu_torch.train`
  and its `render` / `metrics`). Any other value is a script path and
  behaves as in the JAX harness (`entry` joined to `repo_dir`, the render
  and metrics entries as given), so the harness still drives an external
  repo or the JAX scripts.
- **The device.** When a run's flattened args carry `device`, the render
  and metrics stages get `--device <d>` too (the train stage gets it
  through `arg_map`). The default config (`benchmark/config.yaml`, used
  when `-c` is not given) carries none, so every stage runs on the CLIs'
  default, `cuda`.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import itertools
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path

import yaml

from .bench_tables import BenchTables

DEFAULT_CONFIG = str(Path(__file__).with_name("config.yaml"))


def slug(s: str) -> str:
    s = re.sub(r"[^a-z0-9._-]+", "-", s.strip().lower())
    return re.sub(r"-{2,}", "-", s).strip("-") or "run"


def deep_merge(base, override):
    """Layer `override` onto `base`: dicts merge recursively, an explicit
    None in the override keeps the base value, anything else replaces it
    (YAML override semantics of `fs3dgs_benchmark/benchmark.py:22`)."""
    if not (isinstance(base, dict) and isinstance(override, dict)):
        return base if override is None else override
    merged = dict(base)
    merged.update({key: deep_merge(base.get(key), val)
                   for key, val in override.items()})
    return merged


_REF_PATTERN = re.compile(r"\$\{([^}]+)\}")


def resolve_refs(obj, ctx):
    """Substitute ${dotted.path} placeholders (embedded or whole-string)
    anywhere inside `obj` by walking `ctx` along the dotted path."""
    if isinstance(obj, dict):
        return {key: resolve_refs(val, ctx) for key, val in obj.items()}
    if isinstance(obj, list):
        return [resolve_refs(val, ctx) for val in obj]
    if not isinstance(obj, str):
        return obj

    def deref(match):
        node = ctx
        for part in match.group(1).split("."):
            node = node[part]
        return str(node)

    return _REF_PATTERN.sub(deref, obj)


def flatten_repo_args(args_dict):
    """Collapse one level of param-group nesting into flat flag keys (all
    of the reference's ParamGroups present themselves as flat flags)."""
    flat = {}
    for key, val in args_dict.items():
        flat.update(val if isinstance(val, dict) else {key: val})
    return flat


def build_cli_args(arg_map, flat_args):
    """Emit `--flag value` argv entries for exactly the keys whitelisted in
    `arg_map` (harness keys like `seed` must not leak to the trainer):
    True → bare flag, False/None → omitted, list → flag + items."""
    argv = []
    for key, flag_name in arg_map.items():
        try:
            val = flat_args[key]
        except KeyError:
            continue
        if val is None or val is False:
            continue
        flag = "--" + flag_name
        if val is True:
            argv.append(flag)
        elif isinstance(val, (list, tuple)):
            argv.append(flag)
            argv += [str(item) for item in val]
        else:
            argv += [flag, str(val)]
    return argv


def as_namespace_string(dflat, allowed_keys=None):
    """Render a dict the way argparse prints a Namespace — the cfg_args
    file format the reference's render/metrics `eval()` back in."""
    keep = dflat if allowed_keys is None else {
        key: val for key, val in dflat.items() if key in allowed_keys}
    body = ", ".join("%s=%r" % item for item in keep.items())
    return "Namespace(" + body + ")"


def expand_grid(grid):
    if not grid:
        return [{}]
    keys = list(grid)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(grid[k] for k in keys))]


def entry_argv(entry, repo_dir=None):
    """argv after the interpreter for one stage: `-m <module>` →
    ["-m", module]; a script path → [path], joined to `repo_dir` when one
    is given (the train entry, as in the JAX harness)."""
    parts = str(entry).split()
    if len(parts) == 2 and parts[0] == "-m":
        return parts
    return [str(repo_dir / entry) if repo_dir is not None else entry]


def build_runs(cfg, out_root: Path, python: str):
    ctx = {"defaults": cfg.get("defaults", {}), "scenes": {}}
    scenes = []
    user_scenes = cfg.get("scenes") or []
    if user_scenes and any(("name" in s or "source_path" in s)
                           for s in user_scenes):
        for s in user_scenes:
            s = resolve_refs(s, ctx)
            scenes.append({"name": s["name"], "source_path": s["source_path"]})
    else:
        root = Path(cfg["defaults"]["dataset_root"]).expanduser().resolve()
        if not root.is_dir():
            raise SystemExit(
                f"No scenes in config and dataset_root does not exist: "
                f"{root} — list `scenes:` or point `defaults.dataset_root` "
                f"at a directory of scene folders")
        for sub in sorted(root.iterdir()):
            if sub.is_dir():
                scenes.append({"name": sub.name, "source_path": str(sub)})

    runs = []
    for scene in scenes:
        for model in cfg.get("models", []):
            model_name = model["name"]
            ov = (cfg.get("overrides") or {}).get(model_name, {}).get(
                scene["name"], {})
            base_args = deep_merge(cfg["defaults"].get("common_args", {}),
                                   model.get("args", {}))
            base_args["source_path"] = scene["source_path"]
            for grid_vars in expand_grid(cfg.get("grid", {})):
                seeds = grid_vars.get("seeds",
                                      cfg["defaults"].get("seeds", [42]))
                for seed in (seeds if isinstance(seeds, list) else [seeds]):
                    merged = deep_merge(deep_merge(base_args, grid_vars),
                                        ov.get("args", {}))
                    merged["seed"] = seed
                    flat = flatten_repo_args(merged)
                    tag = (f"{scene['name']}__{model_name}"
                           f"__sh{flat.get('sh_degree', 'NA')}"
                           f"__it{flat.get('iterations', 'NA')}__seed{seed}")
                    run_dir = (out_root / tag).resolve()
                    model_path = run_dir / "model"
                    log_dir = run_dir / "logs"
                    model_path.mkdir(parents=True, exist_ok=True)
                    log_dir.mkdir(parents=True, exist_ok=True)
                    flat["model_path"] = str(model_path)
                    flat["source_path"] = str(
                        Path(scene["source_path"]).resolve())

                    repo_dir = Path(model.get("repo_dir", ".")).resolve()
                    entry = entry_argv(model.get("entry", "train.py"),
                                       repo_dir)
                    arg_map = model.get("arg_map", {})
                    if model.get("needs_cfg_args_file", False):
                        with open(model_path / "cfg_args", "w") as f:
                            f.write(as_namespace_string(
                                flat, allowed_keys=set(arg_map)))
                    cli = build_cli_args(arg_map, flat)
                    if model.get("method"):
                        cli = ["--method", str(model["method"])] + cli
                    runs.append({
                        "tag": tag,
                        "scene": scene["name"],
                        "model": model_name,
                        "cmd": [python, *entry] + cli,
                        "env": deep_merge(os.environ.copy(),
                                          cfg["defaults"].get("env", {})),
                        "repo_dir": str(repo_dir),
                        "log_path": str(log_dir / "train.log"),
                        "result_path": str(run_dir / "result.json"),
                        "seed": seed,
                        "args_flat": flat,
                        "model_cfg": model,
                    })
    return runs


def _subprocess_stage(cmd, cwd, env, log_path, label, tag):
    print(f"\n[{label}] Running for {tag}")
    print("CMD:", " ".join(shlex.quote(x) for x in cmd))
    with open(log_path, "w") as logf:
        t0 = time.time()
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        code = proc.wait()
        dur = time.time() - t0
    print(f"[{label}] Finished {tag} in {dur:.2f}s, exit={code}")
    return code, dur


def execute_runs(runs, cfg, out_root: Path, python: str, dry=False,
                 resume=False):
    summary_rows = []
    for r in runs:
        print("\n==> Running:", r["tag"])
        print("CMD:", " ".join(shlex.quote(x) for x in r["cmd"]))
        if dry:
            continue
        if resume:
            # only a run whose training succeeded AND whose metrics stage
            # completed (ssim key present even when null) counts as done —
            # crashed trainings must be retried, not carried forward
            try:
                prev = json.load(open(r["result_path"]))
            except (OSError, ValueError):
                prev = None
            if (isinstance(prev, dict) and "ssim" in prev
                    and prev.get("exit_code") == 0):
                print(f"[Resume] Skipping completed {r['tag']}")
                summary_rows.append({"tag": r["tag"], "scene": r["scene"],
                                     "model": r["model"], "seed": r["seed"],
                                     **prev})
                continue
        code, dur = _subprocess_stage(r["cmd"], r["repo_dir"], r["env"],
                                      r["log_path"], "Train", r["tag"])
        metrics = {"exit_code": code, "duration_sec": round(dur, 2)}
        try:
            log_txt = open(r["log_path"]).read()
            m = re.findall(r"PSNR[:=]?\s*([0-9.]+)", log_txt)
            if m:
                metrics["psnr"] = float(m[-1])
        except OSError:
            pass
        with open(r["result_path"], "w") as f:
            json.dump(metrics, f, indent=2)

        model_cfg = r["model_cfg"]
        defaults = cfg.get("defaults", {})
        model_path = r["args_flat"]["model_path"]
        source_path = r["args_flat"]["source_path"]
        device = r["args_flat"].get("device")
        device_args = ["--device", str(device)] if device else []

        if model_cfg.get("run_render", defaults.get("run_render", False)):
            cmd = [python, *entry_argv(model_cfg.get("render_entry",
                                                     "render.py")),
                   "--model_path", model_path,
                   "--source_path", source_path, "--eval", *device_args]
            _subprocess_stage(cmd, r["repo_dir"], r["env"],
                              str(Path(r["log_path"]).with_name("render.log")),
                              "Render", r["tag"])

        if model_cfg.get("run_metrics", defaults.get("run_metrics", False)):
            it_str = str(r["args_flat"].get("iterations", -1))
            metrics_entry = entry_argv(model_cfg.get("metrics_entry",
                                                     "metrics.py"))
            if r["model"].lower() == "fsgs" and model_cfg.get(
                    "fsgs_metrics_shape", False):
                cmd = [python, *metrics_entry,
                       "--model_path", model_path,
                       "--source_path", source_path, "--iteration", it_str]
            else:
                cmd = [python, *metrics_entry, "--model_paths", model_path]
            _subprocess_stage(cmd + device_args, r["repo_dir"], r["env"],
                              str(Path(r["log_path"]).with_name("metrics.log")),
                              "Metrics", r["tag"])

            for k in ("psnr", "ssim", "lpips"):
                metrics.setdefault(k, None)
            try:
                method = f"ours_{r['args_flat'].get('iterations', 'NA')}"
                rp = Path(model_path) / "results.json"
                if rp.exists():
                    data = json.load(open(rp))
                    block = data.get(method) or (
                        next(iter(data.values())) if data else None)
                    if isinstance(block, dict):
                        for src, dst in (("PSNR", "psnr"), ("SSIM", "ssim"),
                                         ("LPIPS", "lpips"),
                                         ("LPIPS_proxy", "lpips_proxy")):
                            if src in block:
                                metrics[dst] = float(block[src])
                        # never let a proxy LPIPS masquerade as the real
                        # metric in downstream tables (offline envs without
                        # converted VGG16 weights use a tagged proxy)
                        if "LPIPS_backend" in block:
                            metrics["lpips_backend"] = block["LPIPS_backend"]
            except Exception:
                pass

        with open(r["result_path"], "w") as f:
            json.dump(metrics, f, indent=2)
        summary_rows.append({"tag": r["tag"], "scene": r["scene"],
                             "model": r["model"], "seed": r["seed"],
                             **metrics})
        print(f"\n[Done] Completed full pipeline for {r['tag']}")
    return summary_rows


def write_summary(summary_rows, out_root: Path):
    fieldnames = ["tag", "scene", "model", "seed", "exit_code",
                  "duration_sec", "psnr", "ssim", "lpips", "lpips_proxy",
                  "lpips_backend"]
    for row in summary_rows:
        for k in fieldnames:
            row.setdefault(k, None)
    csv_path = out_root / "summary.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(summary_rows)
    print(f"[Summary] Wrote per-run summary to: {csv_path}")
    try:
        tables_dir = BenchTables(summary_rows).export(out_root)
        print(f"[Tables] Wrote LaTeX + PNG tables to: {tables_dir}")
    except Exception as e:
        print("[Tables] Skipped (export error):", e)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=DEFAULT_CONFIG)
    ap.add_argument("--python", default=sys.executable)
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--out_dir", default="",
                    help="use this exact output directory instead of a "
                         "fresh timestamped one (required for --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="skip runs whose result.json shows a completed "
                         "pipeline (use with --out_dir)")
    args = ap.parse_args(argv)

    with open(args.config) as f:
        raw = yaml.safe_load(f)
    cfg = resolve_refs(raw, {"defaults": raw.get("defaults", {}),
                             "scenes": {}})

    base_out = Path(cfg["defaults"].get("out_root",
                                        "./bench_runs")).expanduser().resolve()
    base_out.mkdir(parents=True, exist_ok=True)
    run_desc = cfg["defaults"].get("run_desc", "")
    if args.out_dir:
        out_root = Path(args.out_dir).expanduser().resolve()
    else:
        stamp = f"{datetime.datetime.now():%Y-%m-%d_%H-%M-%S}"
        run_id = f"{stamp}_{slug(run_desc)}" if run_desc else stamp
        out_root = base_out / run_id
    out_root.mkdir(parents=True, exist_ok=True)
    try:
        shutil.copy2(args.config, out_root / "config.yaml")
    except OSError:
        pass

    runs = build_runs(cfg, out_root, args.python)
    summary_rows = execute_runs(runs, cfg, out_root, args.python,
                                dry=args.dry, resume=args.resume)
    if not args.dry and summary_rows:
        write_summary(summary_rows, out_root)


if __name__ == "__main__":
    main()
