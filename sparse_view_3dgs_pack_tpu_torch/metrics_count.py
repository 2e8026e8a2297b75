#!/usr/bin/env python3
"""Gaussian counts of the port's saved models:

    python -m sparse_view_3dgs_pack_tpu_torch.metrics_count -m <model_dir> ...

The port's copy of the root `metrics_count.py` (reference
`DNGaussian/metrics_count.py`): the points of each
`point_cloud/iteration_N/point_cloud.ply`, written to
`<model>/gaussian_counts.json`. Host only; it reads PLY headers and rows.
"""

from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

from .data.ply import read_ply


def main(argv=None) -> int:
    parser = ArgumentParser(description="Gaussian counts per saved PLY")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    args = parser.parse_args(argv)
    for model in args.model_paths:
        counts = {}
        pc_root = os.path.join(model, "point_cloud")
        if not os.path.isdir(pc_root):
            print(f"{model}: no point_cloud dir")
            continue
        for sub in sorted(os.listdir(pc_root)):
            ply_path = os.path.join(pc_root, sub, "point_cloud.ply")
            if os.path.exists(ply_path):
                counts[sub] = int(len(read_ply(ply_path)["x"]))
        print(model, counts)
        with open(os.path.join(model, "gaussian_counts.json"), "w") as f:
            json.dump(counts, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
