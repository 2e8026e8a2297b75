"""Offline full COLMAP reconstruction (reference
`dataset_preprocessing/full_colmap.py:42-160`).

Subprocess glue around the COLMAP binary: feature_extractor →
exhaustive_matcher → mapper (with relaxed-tri-angle retry) →
image_undistorter, then moves sparse output into `sparse/0` and optionally
generates ½/¼/⅛ image pyramids (PIL here instead of ImageMagick — no external
dependency).

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/full_colmap.py`
(host only).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess


def run_cmd(cmd: list[str], check: bool = True):
    print("[CMD]", " ".join(cmd))
    result = subprocess.run(cmd)
    if check and result.returncode != 0:
        raise subprocess.CalledProcessError(result.returncode, cmd)
    return result.returncode


def run_full_colmap(scene_root: str, input_folder: str = "input",
                    colmap_command: str = "colmap",
                    camera_model: str = "OPENCV", use_gpu: bool = False,
                    skip_matching: bool = False, resize: bool = False,
                    sift_max_features: int = 8192):
    distorted = os.path.join(scene_root, "distorted")
    distorted_sparse = os.path.join(distorted, "sparse")
    input_dir = os.path.join(scene_root, input_folder)
    db_path = os.path.join(distorted, "database.db")

    if not skip_matching:
        os.makedirs(distorted_sparse, exist_ok=True)
        run_cmd([colmap_command, "feature_extractor",
                 "--database_path", db_path,
                 "--image_path", input_dir,
                 "--ImageReader.single_camera", "1",
                 "--ImageReader.camera_model", camera_model,
                 "--SiftExtraction.max_num_features", str(sift_max_features),
                 "--SiftExtraction.use_gpu", str(int(use_gpu))])
        run_cmd([colmap_command, "exhaustive_matcher",
                 "--database_path", db_path,
                 "--SiftMatching.use_gpu", str(int(use_gpu))])
        mapper = [colmap_command, "mapper",
                  "--database_path", db_path,
                  "--image_path", input_dir,
                  "--output_path", distorted_sparse,
                  "--Mapper.ba_global_function_tolerance=0.000001"]
        try:
            run_cmd(mapper)
        except subprocess.CalledProcessError:
            logging.warning("mapper failed; retrying with "
                            "init_min_tri_angle=4")
            run_cmd(mapper + ["--Mapper.init_min_tri_angle", "4"])

    run_cmd([colmap_command, "image_undistorter",
             "--image_path", input_dir,
             "--input_path", os.path.join(distorted_sparse, "0"),
             "--output_path", scene_root,
             "--output_type", "COLMAP"])

    sparse_root = os.path.join(scene_root, "sparse")
    os.makedirs(os.path.join(sparse_root, "0"), exist_ok=True)
    for f in os.listdir(sparse_root):
        if f == "0":
            continue
        src = os.path.join(sparse_root, f)
        if os.path.isfile(src):
            shutil.move(src, os.path.join(sparse_root, "0", f))

    if resize:
        make_image_pyramid(scene_root)
    print("[FULL COLMAP] Completed.")


def make_image_pyramid(scene_root: str):
    """½/¼/⅛ downsampled copies (reference uses ImageMagick mogrify)."""
    from PIL import Image as PILImage

    imgs_dir = os.path.join(scene_root, "images")
    for sub, factor in [("images_2", 2), ("images_4", 4), ("images_8", 8)]:
        out_dir = os.path.join(scene_root, sub)
        os.makedirs(out_dir, exist_ok=True)
        for name in os.listdir(imgs_dir):
            with PILImage.open(os.path.join(imgs_dir, name)) as im:
                im.resize((im.width // factor, im.height // factor),
                          PILImage.LANCZOS).save(os.path.join(out_dir, name))
