"""Cells cut to a size the CPU tests can hold: the configuration's and the
mix's parameters with the frame, the views and the Gaussians made small.
Everything else, the limits too, is the cell's own."""

from __future__ import annotations

import copy

from gsbench import cell as cell_mod

WORKLOADS = ("lgdwt_m360_garden.refine", "3dgs_m360_bicycle.refine",
             "lgdwt_m360_garden.view1080")


def tiny(workload: str, root=cell_mod.ROOT, n: int = 3000, width: int = 64,
         height: int = 48, views: int = 6):
    c = cell_mod.load(workload, root)
    cfg = copy.deepcopy(c.cfg)
    cfg.update(n_gaussians=n, width=width, height=height,
               n_train_views=views,
               focal_px=cfg["focal_px"] * width / cfg["width"])
    cfg["opt"]["patch_size"] = 16
    t = dict(c.traffic)
    if t["entry"] == "view":
        t.update(width=80, height=48, cameras=8, checked_frames=2,
                 sample_span=3, warm_frames=2, traced_frames=4)
    return c._replace(cfg=cfg, traffic=t)
