"""Image IO without PIL: a PNG reader and writer in numpy + zlib.

Handles 8-bit grayscale, gray+alpha, RGB and RGBA PNGs, non-interlaced,
with all five scanline filters (None, Sub, Up, Average, Paeth). Any other
image (JPEG, palette or 16-bit or interlaced PNG) goes through PIL, imported
only when such a file is met; without PIL that raises a clear error.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}   # PNG colour type → samples per pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


class _NotNative(Exception):
    """A file this module does not decode itself."""


def _pil():
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            "this image is not an 8-bit non-interlaced PNG, and PIL, which "
            "the port needs for other formats, is not installed") from exc
    return Image


def _chunks(data: bytes):
    pos = len(_SIG)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _header(data: bytes):
    if not data.startswith(_SIG):
        raise _NotNative("not a PNG")
    ctype, body = next(_chunks(data))
    if ctype != b"IHDR":
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return w, h, depth, color, interlace


def image_size(path: str) -> tuple[int, int]:
    """(width, height) from the header; PIL for non-PNG files."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head.startswith(_SIG):
        w, h, *_ = _header(head)
        return w, h
    with _pil().open(path) as im:
        return im.size


def _unfilter(raw: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:     # Sub: running sum over each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:     # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            ln, up = line.tolist(), prev.tolist()
            c = [0] * stride
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc
                            else up[i] if pb <= pc else ul)
                c[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(c, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_png_native(data: bytes) -> np.ndarray:
    w, h, depth, color, interlace = _header(data)
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise _NotNative(f"PNG depth={depth} colour={color} "
                         f"interlace={interlace}")
    idat = b"".join(body for ctype, body in _chunks(data) if ctype == b"IDAT")
    ch = _CHANNELS[color]
    img = _unfilter(zlib.decompress(idat), w, h, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_image(path: str) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) array, as `np.asarray(PIL.Image.open())`."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _read_png_native(data)
    except _NotNative:
        with _pil().open(path) as im:
            return np.asarray(im)


def resize(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """LANCZOS resize to (width, height) — through PIL, as the reference."""
    Image = _pil()
    return np.asarray(Image.fromarray(arr).resize(size, Image.LANCZOS))


def _filter_rows(img: np.ndarray, bpp: int, ftype: int) -> bytes:
    h = img.shape[0]
    x = img.reshape(h, -1).astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    else:
        raise ValueError(f"PNG filter type must be 0..4, got {ftype}")
    filt = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([np.full((h, 1), ftype, np.uint8), filt],
                          axis=1).tobytes()


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write a uint8 (H, W) or (H, W, 1|2|3|4) array as an 8-bit PNG, every
    row with filter `filter_type`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, got {ch}")

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    idat = zlib.compress(_filter_rows(img, ch, filter_type), 6)
    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat)
                + chunk(b"IEND", b""))
