"""Training traffic: `Trainer.step` of the port, one view a step, from the
configuration's iteration on (past the densify window: no densify event,
no opacity reset).

Set-up builds one `Trainer` from the seed's state and drives it through
its first `checked_steps` steps, which the reference follows: each step's
loss, every leaf's gradient at the first step (worked out from Adam's
first moment after it, which starts at zero) and every leaf's change
after the last. Then it warms up and hands the same trainer to the
window: as many steps as the window holds, each through `Trainer.step`,
the window ending in a synchronize. `train_it_per_s` is the steps
completed over the window's seconds.
"""

from __future__ import annotations

import time

import torch

from .. import program, scene
from ..reference import render as ref_render
from ..reference import train as ref_train
from . import Outcome, Patches, counted, gaps, measure, norms, sync

BETA1 = 0.9


def views(cfg: dict, seed: int) -> list:
    return scene.ring_views(cfg["ring"], cfg["n_train_views"], cfg["width"],
                            cfg["height"], cfg["focal_px"], seed, 0)


def plant(faults, patches: Patches) -> None:
    """The named faults, planted in the port's step."""
    from sparse_view_3dgs_pack_tpu_torch.parallel import dp
    from sparse_view_3dgs_pack_tpu_torch.train import step as port_step
    if "state_unchanged" in faults:
        patches.setattr(dp, "adam_update", lambda *a, **k: None)
    if "half_batch" in faults:
        full = port_step.photometric_losses

        def half(image, gt, running, cfg):
            rows = image.shape[0] // 2
            return full(image[:rows], gt[:rows], running, cfg)
        patches.setattr(port_step, "photometric_losses", half)


def program_side(cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, faults=()) -> dict:
    """Set-up, the checked steps and the window on the program; what the
    reference needs to follow it, and the window's readings."""
    cfg, tr_cfg = cell.cfg, cell.traffic
    marks = [("imports", time.perf_counter() - t0)]
    vs = views(cfg, seed)
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    with Patches() as patches:
        plant(faults, patches)
        trainer = program.trainer(cfg, params, vs, seed, device)
        del params
        sync()
        marks.append(("cloud, trainer, targets", time.perf_counter() - t0))
        n = len(vs)
        taken, losses = [], []
        for i in range(tr_cfg["checked_steps"]):
            before = list(trainer.viewpoint_stack)
            metrics = trainer.step()
            taken.append(program.taken_view(before, trainer.viewpoint_stack,
                                            n))
            losses.append(float(metrics["loss"]))
            if i == 0:
                grad = norms({k: m / (1 - BETA1)
                              for k, m in trainer.adam.m.items()})
        start = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                                 cfg["sh_degree"], seed, device)
        delta = norms({k: p.detach() - start[k]
                       for k, p in trainer.model.params().items()})
        del start
        marks.append(("checked steps", time.perf_counter() - t0))
        for _ in range(tr_cfg["warm_steps"]):
            trainer.step()
        sync()
        setup_s = time.perf_counter() - t0
        marks.append(("warm steps", setup_s))

        stack = []

        def call(i):
            stack.append(list(trainer.viewpoint_stack))
            trainer.step()
            stack[-1] = program.taken_view(stack[-1],
                                           trainer.viewpoint_stack, n)

        win = measure(call, seconds, trace, tr_cfg["traced_steps"], False)
    peak = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else 0)
    del trainer
    program.free()
    return dict(views=vs, taken=taken, losses=losses, grad=grad,
                delta=delta, setup_s=setup_s, marks=marks, window=win,
                peak=peak,
                traced_views=[stack[i] for i in win.traced])


def reference_side(cell, seed: int, device, got: dict, trace: bool,
                   tf32: bool = False) -> dict:
    """The reference's steps from the same seed-made state over the views
    the program's checked steps took; with `trace`, the work of each
    traced step's view, replayed on the starting state."""
    cfg = cell.cfg
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    W, H = cfg["width"], cfg["height"]
    work = None
    if trace:
        work = [ref_render.count_work(params, got["views"][v], W, H,
                                      cfg["sh_degree"], 16, 16)
                for v in got["traced_views"]]
    m, v = scene.adam_moments(params, cfg["adam_v_scale"], seed)
    start = {k: p.clone() for k, p in params.items()}
    targets = scene.make_targets(cfg["targets"], len(got["views"]), W, H,
                                 seed, device, only=got["taken"])
    out = ref_train.steps(params, m, v, cfg["iteration"], cfg["iteration"],
                          [got["views"][i] for i in got["taken"]], targets,
                          cfg, program.extent(got["views"]), tf32=tf32)
    out["delta"] = norms({k: params[k] - start[k] for k in params})
    out["work_traced"] = work
    del params, start, m, v, targets
    program.free()
    return out


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers: the worst step's relative loss gap, the worst
    counted leaf's gap of first-gradient norms and of the change's norms."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(got["losses"],
                                                    ref["loss"]))
    leaves = counted(ref["grad_norm"])
    return {"loss_gap": loss,
            "grad_gap": gaps(got["grad"], ref["grad_norm"], leaves),
            "delta_gap": gaps(got["delta"], ref["delta"], leaves)}


def trace_context(cell, got: dict, ref: dict) -> dict:
    cfg = cell.cfg
    return {"kind": "train", "trace": got["window"].trace,
            "call_s": got["window"].untraced_call_s,
            "work": ref["work_traced"], "P": cfg["n_gaussians"],
            "n_values": cfg["n_gaussians"] * (3 + 3 * (cfg["sh_degree"] + 1)
                                              ** 2 + 3 + 4 + 1),
            "width": cfg["width"], "height": cfg["height"],
            "dwt": bool(cfg["opt"].get("dwt_enable", False)), "C": 3}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        faults=()) -> Outcome:
    got = program_side(cell, seed, seconds, trace, device, t0, faults)
    ref = reference_side(cell, seed, device, got, trace)
    win = got["window"]
    return Outcome(
        end_to_end={"train_it_per_s": win.calls / win.seconds,
                    "setup_s": got["setup_s"]},
        attempted=win.calls, failed=0, checks=compare(got, ref),
        memory_peak_bytes=got["peak"],
        trace=trace_context(cell, got, ref) if trace else None,
        setup=got["marks"])
