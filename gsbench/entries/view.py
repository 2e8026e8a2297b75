"""Viewer traffic: `renderer.render` of the port, one client in a closed
loop (each frame synchronised before the next is asked for), over the
mix's seeded ring cameras in turn, of the configuration's seed-made
cloud.

`render_fps` is the frames completed over the window's seconds;
`frame_ms_p95` the 95th percentile over every frame of the window, each
timed from the host's request until its image is ready on the card. A
sample of the window's frames, drawn from the seed before the window, is
kept as the program produced it and compared with the reference's frame
of the same camera once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, scene
from ..reference import render as ref_render
from . import Outcome, Patches, measure, sync


def views(cell, seed: int) -> list:
    cfg, t = cell.cfg, cell.traffic
    focal = cfg["focal_px"] * t["width"] / cfg["width"]   # the same fov
    return scene.ring_views(cfg["ring"], t["cameras"],
                            t["width"], t["height"], focal, seed, 1)


def plant(faults, patches: Patches) -> None:
    """The named faults, planted where a frame is produced."""
    from sparse_view_3dgs_pack_tpu_torch import renderer
    if "answer_altered" in faults:
        full = renderer.render_core

        def altered(*a, **k):
            res = full(*a, **k)
            img = res.render.clone()
            img[img.shape[0] // 2, img.shape[1] // 2] += 0.1
            return res._replace(render=img)
        patches.setattr(renderer, "render_core", altered)


def program_side(cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, faults=()) -> dict:
    from sparse_view_3dgs_pack_tpu_torch.renderer import render
    cfg, t = cell.cfg, cell.traffic
    marks = [("imports", time.perf_counter() - t0)]
    vs = views(cell, seed)
    cams = [program.Camera(v, t["width"], t["height"]) for v in vs]
    # the sampled frames: positions in the window drawn from the seed among
    # its first `sample_span` frames, which any window renders
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    span = min(t["sample_span"], len(cams))
    sample = sorted(rng.choice(span, t["checked_frames"],
                               replace=False).tolist())
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    model = program.model(params, 1)
    del params
    bg = torch.zeros(3, device=device)
    sh = cfg["sh_degree"]
    sync()
    marks.append(("cloud, model", time.perf_counter() - t0))
    with Patches() as patches:
        plant(faults, patches)
        for i in range(t["warm_frames"]):
            render(model, cams[i % len(cams)], bg, sh_degree_active=sh)
        sync()
        setup_s = time.perf_counter() - t0
        marks.append(("warm frames", setup_s))
        kept = {}

        def call(i):
            c = i % len(cams)
            res = render(model, cams[c], bg, sh_degree_active=sh)
            if c in sample and c not in kept:
                kept[c] = res.render

        win = measure(call, seconds, trace, t["traced_frames"], True)
    peak = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else 0)
    del model
    program.free()
    return dict(views=vs, kept=kept, sample=sample, setup_s=setup_s,
                marks=marks, window=win, peak=peak,
                traced_views=[i % len(cams) for i in win.traced])


def reference_side(cell, seed: int, device, got: dict, trace: bool,
                   tf32: bool = False) -> dict:
    """The reference's frame of each sampled camera, its widest gap to the
    program's, and with `trace` the work of each traced frame."""
    from ..reference.train import precision
    cfg, t = cell.cfg, cell.traffic
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    bg = torch.zeros(3, device=device)
    gap, missing = 0.0, [c for c in got["sample"] if c not in got["kept"]]
    with precision(tf32):
        for c, img in got["kept"].items():
            ref, _, _ = ref_render.render_frame(
                params, got["views"][c], t["width"], t["height"], bg,
                cfg["sh_degree"])
            gap = max(gap, float((img - ref).abs().max()))
    work = None
    if trace:
        work = [ref_render.count_work(params, got["views"][c], t["width"],
                                      t["height"], cfg["sh_degree"], 32, 16)
                for c in got["traced_views"]]
    del params
    program.free()
    # a sampled frame that never came is wrong, not late: the loop is closed
    return {"frame_gap": float("inf") if missing else gap,
            "work_traced": work}


def trace_context(cell, got: dict, ref: dict) -> dict:
    t = cell.traffic
    return {"kind": "view", "trace": got["window"].trace,
            "call_s": got["window"].untraced_call_s,
            "work": ref["work_traced"], "P": cell.cfg["n_gaussians"],
            "width": t["width"], "height": t["height"], "C": 3}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        faults=()) -> Outcome:
    got = program_side(cell, seed, seconds, trace, device, t0, faults)
    ref = reference_side(cell, seed, device, got, trace)
    win = got["window"]
    ms = [1e3 * s for s in win.call_s]
    return Outcome(
        end_to_end={"render_fps": win.calls / win.seconds,
                    "frame_ms_p95": float(np.percentile(ms, 95)),
                    "setup_s": got["setup_s"]},
        attempted=win.calls, failed=0,
        checks={"frame_gap": ref["frame_gap"]},
        memory_peak_bytes=got["peak"],
        trace=trace_context(cell, got, ref) if trace else None,
        setup=got["marks"])
