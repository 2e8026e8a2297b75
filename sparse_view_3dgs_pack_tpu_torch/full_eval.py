"""Full-evaluation runner — role of the reference `full_eval.py`: trains,
renders, and evaluates every scene of the standard benchmark sets
(MipNeRF360 / Tanks&Temples / DeepBlending layout) through the port's
train/render/metrics CLIs.

    python -m sparse_view_3dgs_pack_tpu_torch.full_eval -m360 <dir> \
        -tat <dir> -db <dir> [--method lgdwt] [--output_path ./eval]

The port's counterpart of the root `full_eval.py`: the same scene lists,
per-set `-i images_4|images_2` flags and skip flags, with each stage run
as `python -m sparse_view_3dgs_pack_tpu_torch.train|render|metrics`.
"""

import os
import subprocess
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump",
                             "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]

PACKAGE = "sparse_view_3dgs_pack_tpu_torch"


def run(cmd):
    print(" ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default=None)
    parser.add_argument("--tanksandtemples", "-tat", type=str, default=None)
    parser.add_argument("--deepblending", "-db", type=str, default=None)
    parser.add_argument("--method", type=str, default="lgdwt")
    args, _ = parser.parse_known_args(argv)

    py = sys.executable

    jobs = []
    if args.mipnerf360:
        for s in mipnerf360_outdoor_scenes:
            jobs.append((os.path.join(args.mipnerf360, s), s, ["-i",
                                                               "images_4"]))
        for s in mipnerf360_indoor_scenes:
            jobs.append((os.path.join(args.mipnerf360, s), s, ["-i",
                                                               "images_2"]))
    if args.tanksandtemples:
        for s in tanks_and_temples_scenes:
            jobs.append((os.path.join(args.tanksandtemples, s), s, []))
    if args.deepblending:
        for s in deep_blending_scenes:
            jobs.append((os.path.join(args.deepblending, s), s, []))

    if not jobs:
        print("no dataset roots given; use -m360/-tat/-db")
        return

    all_model_paths = []
    for source, scene, extra in jobs:
        model_path = os.path.join(args.output_path, scene)
        all_model_paths.append(model_path)
        if not args.skip_training:
            run([py, "-m", f"{PACKAGE}.train", "--method", args.method,
                 "-s", source, "-m", model_path, "--eval", "--quiet",
                 "--disable_viewer"] + extra)
        if not args.skip_rendering:
            run([py, "-m", f"{PACKAGE}.render", "-m", model_path,
                 "--quiet", "--eval", "--skip_train"])
    if not args.skip_metrics:
        run([py, "-m", f"{PACKAGE}.metrics", "-m"] + all_model_paths)


if __name__ == "__main__":
    main()
