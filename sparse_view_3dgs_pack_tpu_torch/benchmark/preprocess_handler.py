"""Dataset preprocessing hooks for the harness (reference
`fs3dgs_benchmark/preprocess_handler.py:11-106` — largely stubbed there too).

`check_dataset_compatibility` validates the expected scene layout;
`handle_dataset_preprocessing` optionally invokes the offline COLMAP pipeline
(`sparse_view_3dgs_pack_tpu_torch.preprocessing`) when a model requests a
few-shot dense initialisation that does not exist yet.

The port's copy of `sparse_view_3dgs_pack_tpu/benchmark/preprocess_handler.py`
(host only).
"""

from __future__ import annotations

import logging
import os


def check_dataset_compatibility(source_path: str) -> bool:
    """A usable scene has images plus either a COLMAP sparse model or Blender
    transforms."""
    has_images = any(os.path.isdir(os.path.join(source_path, d))
                     for d in ("images", "train"))
    has_sparse = os.path.isdir(os.path.join(source_path, "sparse"))
    has_blender = os.path.exists(os.path.join(source_path,
                                              "transforms_train.json"))
    return has_images and (has_sparse or has_blender)


def handle_dataset_preprocessing(model_cfg: dict, scene: dict,
                                 defaults: dict) -> str:
    source_path = scene["source_path"]
    if not check_dataset_compatibility(source_path):
        raise ValueError(f"{source_path}: missing images/ + sparse/ or "
                         "transforms_train.json")
    n_views = (model_cfg.get("args", {}) or {}).get("n_views", 0)
    pc_type = (model_cfg.get("args", {}) or {}).get("point_cloud_type",
                                                    "sparse")
    if n_views and pc_type == "dense":
        dense = os.path.join(source_path, f"{n_views}_views/dense/fused.ply")
        if not os.path.exists(dense):
            logging.warning(
                "[Preprocessing] %s missing; run "
                "`python -m "
                "sparse_view_3dgs_pack_tpu_torch.preprocessing.fewshot_colmap "
                "--source %s --n_views %d` (requires the COLMAP binary)",
                dense, source_path, n_views)
    return source_path
