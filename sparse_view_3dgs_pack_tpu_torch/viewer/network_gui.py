"""SIBR remote-viewer TCP bridge (reference
`gaussian_renderer/network_gui.py:26-86`).

Wire protocol kept byte-compatible so existing SIBR remote-viewer binaries
connect to the trainer unchanged: inbound 4-byte little-endian length +
JSON camera message; outbound raw H·W·3 uint8 image bytes followed by a
length-prefixed verify string (the model path).

The incoming view/proj matrices use the reference's transposed row-vector
convention with flipped y/z columns; they are converted to this framework's
math convention here.

The port's copy of `sparse_view_3dgs_pack_tpu/viewer/network_gui.py`. Its
one change: `render_to_bytes` also takes a torch tensor, packs it to uint8
on the tensor's device and copies only the packed bytes to the host.
"""

from __future__ import annotations

import json
import socket
import traceback

import numpy as np
import torch

from ..data.cameras import MiniCam

host = "127.0.0.1"
port = 6009

conn = None
addr = None
listener = None


def init(wish_host: str, wish_port: int) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        listener.bind((host, port))
        listener.listen()
        listener.settimeout(0)
    except OSError as e:
        print(f"[network_gui] disabled ({e})")
        listener = None


def try_connect() -> None:
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except (BlockingIOError, OSError):
        pass


def _recv_exact(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("viewer closed")
        buf += chunk
    return buf


def read() -> dict:
    n = int.from_bytes(_recv_exact(4), "little")
    return json.loads(_recv_exact(n).decode("utf-8"))


def send(message_bytes, verify: str) -> None:
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive():
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None
    try:
        do_training = bool(message["train"])
        fovy = message["fov_y"]
        fovx = message["fov_x"]
        znear = message["z_near"]
        zfar = message["z_far"]
        do_shs_python = bool(message["shs_python"])
        do_rot_scale_python = bool(message["rot_scale_python"])
        keep_alive = bool(message["keep_alive"])
        scaling_modifier = message["scaling_modifier"]

        wvt = np.array(message["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        fpt = np.array(message["view_projection_matrix"],
                       np.float32).reshape(4, 4)
        fpt[:, 1] = -fpt[:, 1]
        # reference stores transposed (row-vector) matrices; ours are math
        # convention
        cam = MiniCam(width, height, fovy, fovx, znear, zfar,
                      wvt.T, fpt.T)
    except Exception as e:
        traceback.print_exc()
        raise e
    return (cam, do_training, do_shs_python, do_rot_scale_python, keep_alive,
            scaling_modifier)


def pack_u8(image):
    """(H, W, 3) uint8 of a float image in [0, 1]: clamp, × 255, truncate,
    as `(np.clip(x, 0, 1) * 255).astype(np.uint8)`. A torch tensor, (H, W,
    3) or (3, H, W), is packed on its own device and stays there."""
    if not isinstance(image, torch.Tensor):
        return (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    if image.shape[-1] != 3:
        image = image.permute(1, 2, 0)
    return (image.clamp(0, 1) * 255).to(torch.uint8).contiguous()


def render_to_bytes(image) -> bytes:
    """(H, W, 3) float [0,1] → raw uint8 bytes (the SIBR wire format); a
    torch tensor crosses to the host once, already packed."""
    packed = pack_u8(image)
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    return packed.tobytes()


def serve_once(render_fn, source_path: str):
    """Poll/serve one viewer interaction; returns False if training should
    pause (viewer sent do_training=False). `render_fn(MiniCam,
    scaling_modifier) -> (H,W,3) image`."""
    global conn
    if conn is None:
        try_connect()
    keep_training = True
    while conn is not None:
        try:
            cam, do_training, _, _, keep_alive, scaling_modifier = receive()
            if cam is not None:
                image = render_fn(cam, scaling_modifier)
                send(render_to_bytes(image), source_path)
            else:
                send(None, source_path)
            keep_training = bool(do_training) if do_training is not None \
                else True
            if do_training or not keep_alive:
                break
        except Exception as e:
            if not isinstance(e, (ConnectionError, OSError)):
                traceback.print_exc()
            conn = None
    return keep_training
