"""DNGaussian training traffic: `DNGTrainer.step` of the port, one view an
iteration from the shuffled stack and a patch size drawn from 5–16, from
the configuration's iteration on: the hard, soft and photometric passes,
each with its forward, backward and Adam step.

Set-up builds one `DNGTrainer` from the seed's state (`gsbench/llff.py`)
and drives it through its first `checked_steps` iterations, which the
reference (`reference/dng.py`) follows over the same views and patch
sizes: each pass's loss in each iteration, every leaf's first gradient
(from the Adams' first moments after the first iteration, which start at
zero: a fixed combination of the passes' gradients on both sides), and
every leaf's change after the last, the Gaussians' and the field's. Then
it warms up and hands the same trainer to the window: as many iterations
as the window holds, the window ending in a synchronize.
`train_it_per_s` is the iterations completed over the window's seconds.

    python3 -m gsbench.entries.dng --workload <name> --seeds 1,2,3
        [--control] [--faults half_batch,state_unchanged,coarse_grid]

prints, a line a seed, the readings a cell's limits are set from (as
`gsbench.calibrate` does for the other entries): the program's compared
numbers, the control's (the reference at TF32 in the program's place)
and each planted fault's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import llff, program, scene
from ..reference import dng as ref_dng
from . import Outcome, Patches, counted, gaps, measure, norms, sync

BETA1 = 0.9
PASSES = ("hard", "soft", "photo")
FAULTS = ("half_batch", "state_unchanged", "coarse_grid")


def views(cfg: dict, seed: int) -> list:
    return llff.arc_views(cfg["arc"], cfg["n_train_views"], cfg["width"],
                          cfg["height"], cfg["focal_px"], seed)


def plant(faults, patches: Patches) -> None:
    """The named faults, planted in the port's iteration: the photometric
    loss on half the rows, every Adam step skipped, the finest hash
    level's features left out of the field."""
    from sparse_view_3dgs_pack_tpu_torch.models import neural_field
    from sparse_view_3dgs_pack_tpu_torch.train import dng_loop
    if "state_unchanged" in faults:
        patches.setattr(dng_loop, "adam_update", lambda *a, **k: None)
    if "half_batch" in faults:
        full = dng_loop._photo_loss

        def half(image, view, params, field, cfg):
            rows = image.shape[0] // 2
            return full(image[:rows], view._replace(
                gt=view.gt[:rows], alpha_mask=view.alpha_mask[:rows]),
                params, field, cfg)
        patches.setattr(dng_loop, "_photo_loss", half)
    if "coarse_grid" in faults:
        enc = neural_field.hashgrid_encode

        def coarse(table, x, cfg, bound):
            out = enc(table, x, cfg, bound)
            return torch.cat([out[:, :-cfg.level_dim],
                              torch.zeros_like(out[:, -cfg.level_dim:])], 1)
        patches.setattr(neural_field, "hashgrid_encode", coarse)


def _first_grads(tr) -> dict:
    """Each leaf's first moment ÷ (1 − β1), the field's as `field.<name>`."""
    return {**norms({k: m / (1 - BETA1) for k, m in tr.adam.m.items()}),
            **norms({"field." + k: m / (1 - BETA1)
                     for k, m in tr.field_adam.m.items()})}


def program_side(cell, seed: int, seconds: float, trace: bool, device,
                 t0: float, faults=()) -> dict:
    """Set-up, the checked iterations and the window on the program; what
    the reference needs to follow it, and the window's readings."""
    cfg, tr_cfg = cell.cfg, cell.traffic
    marks = [("imports", time.perf_counter() - t0)]
    vs = views(cfg, seed)
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    with Patches() as patches:
        plant(faults, patches)
        trainer = llff.trainer(cfg, params, vs, seed, device)
        del params
        sync()
        marks.append(("cloud, field, trainer, targets",
                      time.perf_counter() - t0))
        taken, patch_idxs, losses = [], [], []
        for i in range(tr_cfg["checked_steps"]):
            metrics = trainer.step()
            taken.append(trainer.cam_idx)
            patch_idxs.append(trainer.patch_idx)
            losses.append([float(metrics[k]) for k in ("hard_loss",
                                                       "soft_loss", "loss")
                           if k in metrics])
            if i == 0:
                grad = _first_grads(trainer)
        start = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                                 cfg["sh_degree"], seed, device)
        start.update({"field." + k: p for k, p in
                      llff.make_field(cfg, seed, device).items()})
        now = {**trainer.model.params(),
               **{"field." + k: p for k, p in trainer.field.params().items()}}
        delta = norms({k: p.detach() - start[k] for k, p in now.items()})
        del start, now
        marks.append(("checked iterations", time.perf_counter() - t0))
        for _ in range(tr_cfg["warm_steps"]):
            trainer.step()
        sync()
        setup_s = time.perf_counter() - t0
        marks.append(("warm iterations", setup_s))

        stack = []

        def call(i):
            trainer.step()
            stack.append(trainer.cam_idx)

        win = measure(call, seconds, trace, tr_cfg["traced_steps"], False)
        passes = [p for p in PASSES if p != "soft" or trainer.cfg.use_soft]
    peak = (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else 0)
    del trainer
    program.free()
    return dict(views=vs, taken=taken, patch_idxs=patch_idxs, losses=losses,
                grad=grad, delta=delta, setup_s=setup_s, marks=marks,
                window=win, peak=peak, passes=passes,
                traced_views=[stack[i] for i in win.traced])


def reference_side(cell, seed: int, device, got: dict, trace: bool,
                   tf32: bool = False) -> dict:
    """The reference's iterations from the same seed-made state over the
    views and patch sizes the program's checked iterations took; with
    `trace`, the work of each traced iteration's renders, replayed on the
    starting state (the soft pass's as the photometric one's)."""
    cfg = cell.cfg
    W, H, n = cfg["width"], cfg["height"], len(got["views"])
    ext = program.extent(got["views"])
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    field = llff.make_field(cfg, seed, device)
    work = None
    if trace:
        replay = {}
        for v in sorted(set(got["traced_views"])):
            for kind in ("hard", "neural"):
                replay[v, kind] = ref_dng.count_work(
                    params, field, cfg, ext, got["views"][v], kind)
        work = [replay[v, "hard" if p == "hard" else "neural"]
                for v in got["traced_views"] for p in got["passes"]]
    m, v = scene.adam_moments(params, cfg["adam_v_scale"], seed)
    fm, fv = llff.field_moments(field, cfg["adam_v_scale"], seed)
    start = {**{k: p.clone() for k, p in params.items()},
             **{"field." + k: p.clone() for k, p in field.items()}}
    targets = scene.make_targets(cfg["targets"], n, W, H, seed, device,
                                 only=got["taken"])
    monos = [255.0 - p for p in llff.make_priors(
        cfg["priors"], n, W, H, seed, device, only=got["taken"])]
    a_step, f_step = llff.adam_steps(cfg)
    out = ref_dng.steps(params, field, m, v, fm, fv, a_step, f_step,
                        cfg["iteration"],
                        [got["views"][i] for i in got["taken"]], targets,
                        monos, got["patch_idxs"], cfg, ext, tf32=tf32)
    now = {**params, **{"field." + k: p for k, p in field.items()}}
    out["delta"] = norms({k: now[k] - start[k] for k in now})
    out["work_traced"] = work
    del params, field, start, now, m, v, fm, fv, targets, monos
    program.free()
    return out


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers: the worst pass's relative loss gap over the
    checked iterations; the worst counted leaf's gap of first-gradient
    norms and of the change's norms."""
    loss = max(abs(p - r) / abs(r)
               for ps, rs in zip(got["losses"], ref["loss"])
               for p, r in zip(ps, rs, strict=True))
    leaves = counted(ref["grad_norm"])
    return {"loss_gap": loss,
            "grad_gap": gaps(got["grad"], ref["grad_norm"], leaves),
            "delta_gap": gaps(got["delta"], ref["delta"], leaves)}


def trace_context(cell, got: dict, ref: dict) -> dict:
    cfg = cell.cfg
    P = cfg["n_gaussians"]
    f = cfg["field"]
    return {"kind": "dng", "trace": got["window"].trace,
            "call_s": got["window"].untraced_call_s,
            "work": ref["work_traced"], "passes": got["passes"], "P": P,
            "n_values": P * (3 + 3 * (cfg["sh_degree"] + 1) ** 2 + 3 + 4
                             + 1),
            "field": f, "width": cfg["width"], "height": cfg["height"],
            "C": 3}


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


def calibrate(cell, seeds, device, control: bool = False,
              faults=()) -> list:
    """Per seed, the readings the limits are set from: the program's
    compared numbers against the reference, with `control` the
    reference's at TF32 against it, and each fault's."""
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        got = program_side(cell, seed, 0.0, False, device, t0)
        ref = reference_side(cell, seed, device, got, False)
        line = {"seed": seed, "setup_s": got["setup_s"],
                "memory_peak_bytes": got["peak"],
                "program": compare(got, ref), "losses": got["losses"],
                "ref_losses": ref["loss"], "grad": got["grad"],
                "ref_grad": ref["grad_norm"], "delta": got["delta"],
                "ref_delta": ref["delta"], "patch_idxs": got["patch_idxs"],
                "taken": got["taken"]}
        if control:
            ctl = reference_side(cell, seed, device, got, False, tf32=True)
            line["control"] = compare({"losses": ctl["loss"],
                                       "grad": ctl["grad_norm"],
                                       "delta": ctl["delta"]}, ref)
        for f in faults:
            bad = program_side(cell, seed, 0.0, False, device,
                               time.perf_counter(), faults=(f,))
            line[f] = compare(bad, reference_side(cell, seed, device, bad,
                                                  False))
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gsbench.entries.dng")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    a = p.parse_args(argv)
    from ..cell import load
    cell = load(a.workload)
    program.build_kernels()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    calibrate(cell, [int(s) for s in a.seeds.split(",")], device, a.control,
              [f for f in a.faults.split(",") if f])


if __name__ == "__main__":
    main()
