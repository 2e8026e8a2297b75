"""The readings that a cell's limits are set from, on the card, at the
cell's own size, several seeds in one process:

    python3 -m gsbench.calibrate --workload <name> --seeds 1,2,3
        [--control] [--faults half_batch,...] [--seconds S]

For each seed, one line of JSON: the program's compared numbers against
the reference (the lower reading); with `--control`, the control's, the
reference computed one precision below the configuration's (TF32 for
float32 with TF32 off) put in the program's place; with `--faults`, the
program's with each named fault planted in the timed path. A benchmark
run never runs any of this. Training needs no measured window; a viewer
cell runs a short one (`--seconds`, long enough to render every sampled
camera).
"""

from __future__ import annotations

import argparse
import importlib
import json
import time


def _control(entry, cell, seed, device, got):
    """(the control's numbers, the reference's outputs): the reference at
    TF32 put in the program's place, against the reference."""
    ref = entry.reference_side(cell, seed, device, got, False)
    if cell.traffic["entry"] == "train":
        ctl = entry.reference_side(cell, seed, device, got, False, tf32=True)
        return entry.compare({"losses": ctl["loss"], "grad": ctl["grad_norm"],
                              "delta": ctl["delta"]}, ref), ref
    import torch

    from . import scene
    from .reference import render as ref_render
    from .reference.train import precision
    t, cfg = cell.traffic, cell.cfg
    params = scene.make_cloud(cfg["scene"], cfg["n_gaussians"],
                              cfg["sh_degree"], seed, device)
    bg = torch.zeros(3, device=device)
    with precision(True):
        kept = {c: ref_render.render_frame(
            params, got["views"][c], t["width"], t["height"], bg,
            cfg["sh_degree"])[0] for c in got["sample"]}
    del params
    ctl = entry.reference_side(cell, seed, device, {**got, "kept": kept},
                               False)
    return {"frame_gap": ctl["frame_gap"]}, ref


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gsbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    a = p.parse_args(argv)
    import torch

    from . import program
    from .cell import load
    cell = load(a.workload)
    program.build_kernels()
    device = torch.device("cuda", 0)
    entry = importlib.import_module(f"gsbench.entries.{cell.traffic['entry']}")
    faults = [f for f in a.faults.split(",") if f]
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        got = entry.program_side(cell, seed, a.seconds, False, device, t0)
        line = {"seed": seed, "setup_s": got["setup_s"],
                "memory_peak_bytes": got["peak"]}
        if a.control:
            line["control"], ref = _control(entry, cell, seed, device, got)
        else:
            ref = entry.reference_side(cell, seed, device, got, False)
        if cell.traffic["entry"] == "train":
            line["program"] = entry.compare(got, ref)
            line["losses"], line["ref_losses"] = got["losses"], ref["loss"]
            line["grad"], line["ref_grad"] = got["grad"], ref["grad_norm"]
            line["delta"], line["ref_delta"] = got["delta"], ref["delta"]
            line["ref_work"] = [list(w) for w in ref["work"]]
            line["ref_pairs"] = ref["pairs"]
        else:
            line["program"] = {"frame_gap": ref["frame_gap"]}
        for f in faults:
            bad = entry.program_side(cell, seed, a.seconds, False, device,
                                     time.perf_counter(), faults=(f,))
            bref = entry.reference_side(cell, seed, device, bad, False)
            line[f] = (entry.compare(bad, bref)
                       if cell.traffic["entry"] == "train"
                       else {"frame_gap": bref["frame_gap"]})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
