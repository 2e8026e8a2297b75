"""Multispectral greenhouse TIFF pipeline (reference
`dataset_preprocessing/process_greenhouse_data.py:45-146`).

Merges two-camera TIFF stacks, composes a pseudo-RGB (G/RedEdge/R) preview
normalised to [0,255], and extracts per-band PNG directories
(images_R/G/RE/NIR) — the NIR directory feeds mult-dwtgs training.

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/greenhouse.py`
(host only).
"""

from __future__ import annotations

import os
import shutil

import numpy as np

BAND_NAMES = ("R", "G", "RE", "NIR")
VALID_EXT = {".tif", ".tiff"}


def get_channels(path):
    """4-band TIFF → (red, green, red_edge, nir), each (H, W, 1) float [0,1]."""
    from PIL import Image as PILImage

    im = PILImage.open(path)
    frames = []
    try:
        i = 0
        while True:
            im.seek(i)
            frames.append(np.asarray(im, dtype=np.float32))
            i += 1
    except EOFError:
        pass
    if len(frames) == 1 and frames[0].ndim == 3 and frames[0].shape[-1] >= 4:
        arr = frames[0]
        bands = [arr[..., i] for i in range(4)]
    elif len(frames) >= 4:
        bands = frames[:4]
    else:
        raise ValueError(f"{path}: expected 4 bands, got {len(frames)} "
                         f"frame(s) of shape {frames[0].shape}")
    out = []
    for b in bands:
        mx = b.max()
        scale = 65535.0 if mx > 255 else (255.0 if mx > 1 else 1.0)
        out.append((b / scale)[..., None])
    return tuple(out)


def merge_tiffs(scene_path: str, scene_name: str) -> str:
    cam1 = os.path.join(scene_path, "TIFF", "Camera1")
    cam2 = os.path.join(scene_path, "TIFF", "Camera2")
    out_dir = os.path.join(scene_path, f"{scene_name}_merged")
    os.makedirs(out_dir, exist_ok=True)

    def imgs(d):
        return {f for f in os.listdir(d)
                if os.path.splitext(f)[1].lower() in VALID_EXT} \
            if os.path.isdir(d) else set()

    f1, f2 = imgs(cam1), imgs(cam2)
    for f in sorted(f1):
        name, ext = os.path.splitext(f)
        shutil.copyfile(os.path.join(cam1, f),
                        os.path.join(out_dir, f"{name}__cam1{ext}"))
    for f in sorted(f2):
        name, ext = os.path.splitext(f)
        shutil.copyfile(os.path.join(cam2, f),
                        os.path.join(out_dir, f"{name}__cam2{ext}"))
    return out_dir


def generate_rgb(scene_path: str, scene_name: str, merged_dir: str) -> str:
    from PIL import Image as PILImage

    out_rgb = os.path.join(scene_path, f"{scene_name}_rgb")
    os.makedirs(out_rgb, exist_ok=True)
    for img in sorted(os.listdir(merged_dir)):
        if os.path.splitext(img)[1].lower() not in VALID_EXT:
            continue
        red, green, red_edge, _ = get_channels(os.path.join(merged_dir, img))
        composite = np.concatenate((green, red_edge, red), axis=-1) * 255
        comp = ((composite - composite.min()) * 255
                / (composite.max() - composite.min() + 1e-8)).astype(np.uint8)
        PILImage.fromarray(comp).save(os.path.join(
            out_rgb, f"processed_{os.path.splitext(img)[0]}.png"))
    return out_rgb


def extract_channels(scene_path: str, merged_dir: str) -> None:
    from PIL import Image as PILImage

    for band in BAND_NAMES:
        os.makedirs(os.path.join(scene_path, f"images_{band}"),
                    exist_ok=True)
    for img in sorted(os.listdir(merged_dir)):
        if os.path.splitext(img)[1].lower() not in VALID_EXT:
            continue
        bands = get_channels(os.path.join(merged_dir, img))
        stem = f"processed_{os.path.splitext(img)[0]}.png"
        for band, arr in zip(BAND_NAMES, bands):
            u8 = np.clip(arr[..., 0] * 255, 0, 255).astype(np.uint8)
            PILImage.fromarray(u8).save(
                os.path.join(scene_path, f"images_{band}", stem))


def process_scene(scene_path: str, scene_name: str) -> None:
    merged = merge_tiffs(scene_path, scene_name)
    generate_rgb(scene_path, scene_name, merged)
    extract_channels(scene_path, merged)
    # mult-dwtgs looks for a sibling nir/ directory next to images/
    nir_src = os.path.join(scene_path, "images_NIR")
    nir_dst = os.path.join(scene_path, "nir")
    if os.path.isdir(nir_src) and not os.path.exists(nir_dst):
        shutil.copytree(nir_src, nir_dst)
