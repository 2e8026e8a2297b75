"""The port's PIL-free PNG reader/writer against PIL, for every scanline
filter type."""

import numpy as np
import pytest
from PIL import Image

from sparse_view_3dgs_pack_tpu_torch.utils import image_io

SHAPES = {"L": (13, 17), "LA": (13, 17, 2), "RGB": (13, 17, 3),
          "RGBA": (13, 17, 4)}


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[3:6] = 200          # flat runs: Sub/Up/Paeth predict exactly
    img[:, 2] = img[:, 1]
    return img


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_round_trip_against_pil(tmp_path, filter_type):
    for seed, (mode, shape) in enumerate(SHAPES.items()):
        img = _image(shape, seed)
        path = str(tmp_path / f"{mode}.png")
        image_io.write_png(path, img, filter_type=filter_type)
        with Image.open(path) as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(image_io.read_image(path), img)
        assert image_io.image_size(path) == (shape[1], shape[0])
        # PIL's encoder picks its own filters per row
        pil_path = str(tmp_path / f"pil_{mode}.png")
        Image.fromarray(img, mode).save(pil_path, optimize=True)
        np.testing.assert_array_equal(image_io.read_image(pil_path), img)


def test_non_png_goes_through_pil(tmp_path):
    img = _image((8, 9, 3), 7)
    path = str(tmp_path / "x.bmp")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    assert image_io.image_size(path) == (9, 8)
    with pytest.raises(ValueError):
        image_io.write_png(str(tmp_path / "bad.png"), img.astype(np.float32))
