"""Dataset production CLI (reference
`dataset_preprocessing/data_pipeline.py:47`):

  --stage full  → part1 + part2
  --stage part1 → full COLMAP reconstruction + poses_bounds.npy
  --stage part2 → few-shot N-view triangulation + MVS dense init

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/data_pipeline.py`
(host only):
`python -m sparse_view_3dgs_pack_tpu_torch.preprocessing.data_pipeline`.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from .fewshot_colmap import run_fewshot_pipeline
from .full_colmap import run_full_colmap
from .llff_poses import gen_poses


def determine_default_features(dataset) -> int:
    return 16384 if dataset == "mipnerf360" else 32768


def main(argv=None):
    ap = ArgumentParser("Modular Few-Shot COLMAP Pipeline")
    ap.add_argument("--base_path", type=str, required=True)
    ap.add_argument("--scene", type=str, required=True)
    ap.add_argument("--input_folder", type=str, default="input")
    ap.add_argument("--stage", type=str, required=True,
                    choices=["full", "part1", "part2"])
    ap.add_argument("--n_views", type=int, default=None)
    ap.add_argument("--max_num_features", type=int, default=None)
    ap.add_argument("--dataset", type=str, default=None,
                    choices=["llff", "mipnerf360"])
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--colmap_command", type=str, default="colmap")
    ap.add_argument("--camera_model", type=str, default="OPENCV")
    ap.add_argument("--use_gpu", action="store_true")
    ap.add_argument("--resize", action="store_true")
    args = ap.parse_args(argv)

    scene_root = os.path.join(args.base_path, args.scene)
    feats = args.max_num_features or determine_default_features(args.dataset)

    if args.stage in ("full", "part1"):
        images_ok = os.path.isdir(os.path.join(scene_root, "images"))
        sparse_ok = os.path.isdir(os.path.join(scene_root, "sparse", "0"))
        if not (images_ok and sparse_ok):
            run_full_colmap(scene_root, args.input_folder,
                            args.colmap_command, args.camera_model,
                            args.use_gpu, skip_matching=False,
                            resize=args.resize)
        if not os.path.exists(os.path.join(scene_root, "poses_bounds.npy")):
            gen_poses(scene_root)

    if args.stage in ("full", "part2"):
        if args.n_views is None:
            raise SystemExit("--n_views required for part2")
        run_fewshot_pipeline(scene_root, args.n_views, args.colmap_command,
                             feats, args.dataset, args.downscale)


if __name__ == "__main__":
    main()
