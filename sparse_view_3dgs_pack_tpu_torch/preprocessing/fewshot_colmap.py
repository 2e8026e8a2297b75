"""Few-shot N-view triangulation + MVS dense init (reference
`dataset_preprocessing/fewshot_colmap.py:212-406`).

From a FULL reconstruction (`sparse/0`), selects the LLFF-hold-8 train views,
subsamples to n_views by linspace, re-extracts SIFT on just those images,
writes `created/images.txt` with known poses in DB order, triangulates with
fixed poses, then runs patch-match stereo + fusion to produce
`{n}_views/dense/fused.ply` — the dense initialisation FSGS/LGDWT expect
(`scene/dataset_readers.py:266`). Requires the COLMAP binary.

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/fewshot_colmap.py`
(host only):
`python -m sparse_view_3dgs_pack_tpu_torch.preprocessing.fewshot_colmap`.
"""

from __future__ import annotations

import os
import shutil
import sqlite3

import numpy as np

from ..data import colmap as colmap_io
from .full_colmap import run_cmd


def resolve_image_folder(scene_root: str, dataset=None, downscale=None):
    """Dataset-aware resolution choice (reference
    `fewshot_colmap.py:149` + `data_pipeline.py:26-35`)."""
    if downscale is None:
        downscale = {"llff": 1, "mipnerf360": 1}.get(dataset or "", 1)
    sub = "images" if downscale in (None, 1) else f"images_{downscale}"
    path = os.path.join(scene_root, sub)
    return path if os.path.isdir(path) else os.path.join(scene_root, "images")


def run_fewshot_pipeline(scene_root: str, n_views: int,
                         colmap_command: str = "colmap",
                         max_num_features: int = 32768,
                         dataset=None, downscale=None,
                         llffhold: int = 8) -> None:
    view_dir = os.path.join(scene_root, f"{n_views}_views")
    if os.path.exists(view_dir):
        shutil.rmtree(view_dir)
    for sub in ("created", "triangulated", "images"):
        os.makedirs(os.path.join(view_dir, sub), exist_ok=True)

    sparse0 = os.path.join(scene_root, "sparse", "0")
    run_cmd([colmap_command, "model_converter", "--input_path", sparse0,
             "--output_path", sparse0, "--output_type", "TXT"])

    cams = colmap_io.read_cameras_text(os.path.join(sparse0, "cameras.txt"))
    camera_model = next(iter(cams.values())).model
    images = colmap_io.read_images_text(os.path.join(sparse0, "images.txt"))
    by_name = {im.name: im for im in images.values()}

    # LLFF holdout + linspace subselect (reference `:287-293`)
    all_imgs = sorted(by_name)
    train_imgs = [c for i, c in enumerate(all_imgs) if i % llffhold != 0]
    if n_views > 0 and train_imgs:
        idx = sorted({int(round(i)) for i in
                      np.linspace(0, len(train_imgs) - 1, n_views)})
        train_imgs = [c for i, c in enumerate(train_imgs) if i in idx]

    base_images = resolve_image_folder(scene_root, dataset, downscale)
    for name in train_imgs:
        shutil.copy2(os.path.join(base_images, name),
                     os.path.join(view_dir, "images", name))

    # created/ model with known intrinsics + empty points
    shutil.copy2(os.path.join(sparse0, "cameras.txt"),
                 os.path.join(view_dir, "created", "cameras.txt"))
    open(os.path.join(view_dir, "created", "points3D.txt"), "w").close()

    old_cwd = os.getcwd()
    os.chdir(view_dir)
    try:
        db_path = "database.db"
        run_cmd([colmap_command, "feature_extractor",
                 "--database_path", db_path, "--image_path", "images",
                 "--ImageReader.camera_model", camera_model,
                 "--ImageReader.single_camera", "1",
                 "--SiftExtraction.max_image_size", "4032",
                 "--SiftExtraction.max_num_features", str(max_num_features),
                 "--SiftExtraction.estimate_affine_shape", "1",
                 "--SiftExtraction.domain_size_pooling", "1"])
        run_cmd([colmap_command, "exhaustive_matcher",
                 "--database_path", db_path,
                 "--SiftMatching.guided_matching", "1",
                 "--SiftMatching.max_num_matches", str(max_num_features)])

        # rewrite created/images.txt in DB order with KNOWN poses
        db = sqlite3.connect(db_path)
        img_rank = [row[1] for row in db.execute(
            "SELECT image_id, name FROM images ORDER BY image_id")]
        db.close()
        with open(os.path.join("created", "images.txt"), "w") as f:
            for i, name in enumerate(img_rank):
                im = by_name[os.path.basename(name)]
                f.write(f"{i + 1} "
                        + " ".join(f"{v:.12g}" for v in im.qvec) + " "
                        + " ".join(f"{v:.12g}" for v in im.tvec)
                        + f" {im.camera_id} {name}\n\n")

        run_cmd([colmap_command, "point_triangulator",
                 "--database_path", db_path, "--image_path", "images",
                 "--input_path", "created", "--output_path", "triangulated",
                 "--Mapper.ba_local_max_num_iterations", "40",
                 "--Mapper.ba_local_max_refinements", "3",
                 "--Mapper.ba_global_max_num_iterations", "100"])
        run_cmd([colmap_command, "model_converter",
                 "--input_path", "triangulated",
                 "--output_path", "triangulated", "--output_type", "TXT"])
        run_cmd([colmap_command, "image_undistorter",
                 "--image_path", "images", "--input_path", "triangulated",
                 "--output_path", "dense"])
        run_cmd([colmap_command, "patch_match_stereo",
                 "--workspace_path", "dense"])
        run_cmd([colmap_command, "stereo_fusion", "--workspace_path",
                 "dense", "--output_path", "dense/fused.ply"])
    finally:
        os.chdir(old_cwd)
    print(f"[FEWSHOT] Completed few-shot reconstruction for "
          f"n_views={n_views}.")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--n_views", type=int, required=True)
    ap.add_argument("--colmap", default="colmap")
    ap.add_argument("--max_features", type=int, default=32768)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--downscale", type=int, default=None)
    a = ap.parse_args(argv)
    run_fewshot_pipeline(a.source, a.n_views, a.colmap, a.max_features,
                         a.dataset, a.downscale)


if __name__ == "__main__":
    main()
