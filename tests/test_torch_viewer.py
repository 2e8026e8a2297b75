"""The port's SIBR remote-viewer bridge (`viewer/network_gui.py`) against the
JAX one: the loopback roundtrip, the reference transcript replayed byte for
byte, `receive` turning the same bytes into the same MiniCam, the uint8
pack bitwise equal to the JAX numpy expression, a frame served by the
port's trainer against the JAX render of the same state, the pause a
`train=False` message holds training in, and the train CLI serving a
viewer. Every listener binds port 0 (the xdist workers never collide)."""

import json
import os
import socket
import sys
import threading
import time
from argparse import ArgumentParser

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import renderer as jax_renderer
from sparse_view_3dgs_pack_tpu.data import cameras as jax_cameras
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.viewer import network_gui as jax_gui
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.config import (ModelParams,
                                                    OptimizationParams,
                                                    PipelineParams)
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.scene import Scene
from sparse_view_3dgs_pack_tpu_torch.train import __main__ as train_cli
from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
from sparse_view_3dgs_pack_tpu_torch.viewer import network_gui
from torch_port import close_viewer, recv_exact, viewer_listener

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "sibr_transcript.json")
MATRIX_TOL = 1e-6     # float32 matrices through JSON: equal in practice
FRAME_LEVELS = 1      # a served frame against the JAX render, uint8 levels
TIMEOUT = 60


def _transcript():
    with open(FIXTURE) as f:
        fix = json.load(f)
    return ([bytes.fromhex(h) for h in fix["client_messages_hex"]],
            bytes.fromhex(fix["server_reply_hex"]), fix)


def _pattern(width, height):
    """The recorder's deterministic frame, (H, W, 3) float32."""
    x = np.arange(width)[None, :, None]
    y = np.arange(height)[:, None, None]
    c = np.arange(3)[None, None, :]
    return (((x * 7 + y * 13 + c * 29) % 255 + 0.5) / 255.0).astype(
        np.float32)


def _serve_until(done, render_fn, verify, deadline=TIMEOUT):
    """Poll `serve_once` as the training loop does until `done()`."""
    end = time.time() + deadline
    while not done() and time.time() < end:
        network_gui.serve_once(render_fn, verify)
        time.sleep(0.005)
    assert done(), "the viewer message was not served in time"


@pytest.mark.parametrize("kind", ["numpy", "tensor_hwc", "tensor_chw"])
def test_network_gui_roundtrip(kind):
    """One length-prefixed JSON camera in, a red frame and the verify
    string out, from a numpy image and from torch tensors in both
    layouts."""
    W, H = 32, 24
    cam = testing.make_orbit_cameras(1, width=W, height_px=H)[0]
    msg = testing.viewer_message(cam, train=True)
    rendered, result = {}, {}

    def render_fn(cam, scaling_modifier):
        rendered["cam"], rendered["scale"] = cam, scaling_modifier
        img = np.zeros((H, W, 3), np.float32)
        img[..., 0] = 1.0          # red frame: recognisable bytes
        if kind == "numpy":
            return img
        t = torch.from_numpy(img)
        return t if kind == "tensor_hwc" else t.permute(2, 0, 1)

    with viewer_listener(network_gui) as port:
        def client():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=TIMEOUT) as s:
                s.sendall(msg)
                img = recv_exact(s, W * H * 3)
                vlen = int.from_bytes(recv_exact(s, 4), "little")
                result["verify"] = recv_exact(s, vlen).decode("ascii")
                result["img"] = np.frombuffer(img, np.uint8).reshape(H, W, 3)

        t = threading.Thread(target=client)
        t.start()
        keep = {}

        def served():
            return "cam" in rendered

        end = time.time() + TIMEOUT
        while not served() and time.time() < end:
            keep["v"] = network_gui.serve_once(render_fn, "/tmp/model")
            time.sleep(0.005)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()

    assert result["verify"] == "/tmp/model"
    assert (result["img"][..., 0] == 255).all()
    assert (result["img"][..., 1:] == 0).all()
    assert keep["v"] is True and rendered["scale"] == 1.0
    got = rendered["cam"]
    assert got.width == W and got.height == H
    np.testing.assert_array_equal(got.world_view_transform,
                                  cam.world_view_transform.astype(np.float32))
    np.testing.assert_array_equal(got.full_proj_transform,
                                  cam.full_proj_transform)


@pytest.mark.parametrize("kind", ["numpy", "tensor_hwc", "tensor_chw"])
def test_bridge_replays_the_reference_transcript(kind):
    """The recorded reference session (`scripts/record_sibr_transcript.py`)
    through the port's bridge: every reply byte equal, whatever form the
    frame takes, and the MiniCams equal to the reference's (transposed
    into the math convention) within MATRIX_TOL."""
    msgs, expected, fix = _transcript()
    cams, chunks = [], []

    def render_fn(cam, scaling_modifier):
        cams.append(cam)
        img = _pattern(cam.width, cam.height)
        if kind == "numpy":
            return img
        t = torch.from_numpy(img)
        return t if kind == "tensor_hwc" else t.permute(2, 0, 1)

    with viewer_listener(network_gui) as port:
        def client():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=TIMEOUT) as s:
                for m in msgs:
                    s.sendall(m)
                s.shutdown(socket.SHUT_WR)
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    chunks.append(chunk)

        t = threading.Thread(target=client)
        t.start()
        _serve_until(lambda: len(cams) == len(fix["minicams"]), render_fn,
                     fix["verify"])
        if network_gui.conn is not None:
            network_gui.conn.close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()

    got = b"".join(chunks)
    assert got == expected, (
        f"{len(got)} vs {len(expected)} bytes, first difference at "
        f"{next((i for i, (a, b) in enumerate(zip(got, expected)) if a != b), -1)}")
    for cam, ref in zip(cams, fix["minicams"]):
        assert (cam.width, cam.height) == (ref["width"], ref["height"])
        for name in ("world_view_transform", "full_proj_transform"):
            np.testing.assert_allclose(
                getattr(cam, name),
                np.array(ref[name], np.float32).reshape(4, 4).T,
                rtol=0, atol=MATRIX_TOL, err_msg=name)


class _Feed:
    """A connection that replays bytes (what `_recv_exact` reads)."""

    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


def test_receive_matches_jax():
    """Both packages' `receive` on the transcript's messages: the same
    flags and scaling modifier, MiniCams equal within MATRIX_TOL."""
    msgs, _, _ = _transcript()
    try:
        network_gui.conn = _Feed(b"".join(msgs))
        jax_gui.conn = _Feed(b"".join(msgs))
        for _ in msgs:
            port_out = network_gui.receive()
            jax_out = jax_gui.receive()
            assert port_out[1:] == jax_out[1:]
            if port_out[0] is None:
                assert jax_out[0] is None
                continue
            pc, jc = port_out[0], jax_out[0]
            for name in ("width", "height", "fovx", "fovy", "znear", "zfar"):
                assert getattr(pc, name) == getattr(jc, name), name
            for name in ("world_view_transform", "full_proj_transform",
                         "camera_center"):
                np.testing.assert_allclose(getattr(pc, name),
                                           np.asarray(getattr(jc, name)),
                                           rtol=0, atol=MATRIX_TOL,
                                           err_msg=name)
        assert network_gui.conn.data == b"" == jax_gui.conn.data
    finally:
        network_gui.conn = jax_gui.conn = None


def test_render_to_bytes_is_the_jax_pack_bitwise():
    """uint8 bytes of torch tensors (HWC and CHW, packed where they lie)
    and of numpy arrays equal the JAX `render_to_bytes` bitwise: values
    outside [0, 1], exact multiples of 1/255 and their float32
    neighbours."""
    rng = np.random.default_rng(0)
    H, W = 24, 40
    img = rng.uniform(-0.2, 1.2, (H, W, 3)).astype(np.float32)
    levels = (np.arange(H * W * 3) % 256 / 255.0).astype(np.float32)
    img.reshape(-1)[::3] = levels[::3]
    img.reshape(-1)[1::3] = np.nextafter(levels[1::3], np.float32(2))
    img.reshape(-1)[2::3] = np.nextafter(levels[2::3], np.float32(-1))
    want = jax_gui.render_to_bytes(img)
    assert network_gui.render_to_bytes(img) == want
    t = torch.from_numpy(img.copy())
    assert network_gui.render_to_bytes(t) == want
    assert network_gui.render_to_bytes(t.permute(2, 0, 1)) == want
    assert network_gui.render_to_bytes(t.permute(2, 0, 1).contiguous()) \
        == want


def _trainer(tmp_path, n_train=2, width=32):
    """A `Trainer` over a tiny Blender scene of a known cloud, with the
    3dgs options (no DWT) on the CPU."""
    cloud = testing.make_gaussian_cloud(7, 100, extent=0.9,
                                        scale_range=(0.05, 0.15))
    scene_dir = testing.write_blender_scene(str(tmp_path / "scene"),
                                            n_train=n_train, n_test=1,
                                            width=width, cloud=cloud,
                                            init_points=60)
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    parser = ArgumentParser()
    lp, op = ModelParams(parser), OptimizationParams(parser, method="3dgs")
    pp = PipelineParams(parser)
    args = parser.parse_args(["-s", scene_dir, "-m", model_dir])
    dataset = lp.extract(args)
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device="cpu")
    return Trainer(scene, op.extract(args), pp.extract(args), dataset)


def _jax_state(n=200, sh=2):
    """A JAX state with spread parameters and faint opacities
    (sigmoid(-2..-1) < 0.27): every α ≥ 1/255 ellipse lies inside its 3σ
    window, so the port's 32×16 inference tiles and JAX's 16×16 cover the
    same pixels (`test_render_nir_is_the_one_channel_render`)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=2, sh_degree=sh,
                                   capacity=256)
    p = {k: np.array(v) for k, v in state.params.items()}
    p["features_rest"][:n] = rng.normal(size=p["features_rest"][:n].shape) \
        * 0.2
    p["opacity"][:n, 0] = rng.uniform(-2.0, -1.0, n)
    p["scaling"][:n] = np.log(rng.uniform(0.04, 0.14, (n, 3)))
    p["rotation"][:n] = rng.normal(size=(n, 4))
    return state._replace(params={k: jnp.asarray(v) for k, v in p.items()})


def test_trainer_serves_the_jax_render(tmp_path, monkeypatch):
    """A frame served by `Trainer.serve_viewer` (the port's inference
    render at the viewer's camera, scaling modifier and the trainer's
    active SH degree) within FRAME_LEVELS uint8 levels of the JAX `render`
    of the same bridged state at the same MiniCam, after the JAX
    `render_to_bytes`."""
    W, H, SH, SCALE = 48, 32, 2, 0.8
    trainer = _trainer(tmp_path)
    state = _jax_state(sh=SH)
    trainer.model = gm.from_jax_state(state, device="cpu").model
    trainer.active_sh_degree = SH
    cam = testing.make_orbit_cameras(1, radius=3.5, width=W,
                                     height_px=H)[0]
    msg = testing.viewer_message(cam, train=True, scaling_modifier=SCALE)
    received, reply = [], {}
    receive = network_gui.receive

    def recording_receive():
        out = receive()
        received.append(out)
        return out

    monkeypatch.setattr(network_gui, "receive", recording_receive)
    verify = trainer.dataset_args.source_path
    with viewer_listener(network_gui) as port:
        def client():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=TIMEOUT) as s:
                s.sendall(msg)
                reply["img"] = recv_exact(s, W * H * 3)
                n = int.from_bytes(recv_exact(s, 4), "little")
                reply["verify"] = recv_exact(s, n).decode("ascii")

        t = threading.Thread(target=client)
        t.start()
        end = time.time() + TIMEOUT
        while not received and time.time() < end:
            trainer.serve_viewer()
            time.sleep(0.005)
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()

    assert reply["verify"] == verify
    mini, scale = received[0][0], received[0][5]
    assert scale == SCALE
    jcam = jax_cameras.MiniCam(W, H, mini.fovy, mini.fovx, mini.znear,
                               mini.zfar, mini.world_view_transform,
                               mini.full_proj_transform)
    ref = jax_renderer.render(state, jcam, np.zeros(3, np.float32),
                              sh_degree_active=SH, scaling_modifier=SCALE)
    want = np.frombuffer(jax_gui.render_to_bytes(np.asarray(ref.render)),
                         np.uint8).astype(np.int16)
    got = np.frombuffer(reply["img"], np.uint8).astype(np.int16)
    assert got.max() > 40, "the frame is nearly black"
    assert np.abs(got - want).max() <= FRAME_LEVELS


def test_pause_holds_the_iteration(tmp_path, monkeypatch):
    """Two train=True frames, one per iteration; then three train=False,
    keep_alive frames and a train=True one, all served inside the next
    iteration's `serve_viewer` (training held, the iteration not
    advancing); once the viewer hangs up, training goes on."""
    W, H = 32, 24
    trainer = _trainer(tmp_path)
    cam = testing.make_orbit_cameras(1, width=W, height_px=H)[0]
    flags = [True, True, False, False, False, True]
    msgs = b"".join(testing.viewer_message(cam, train=f) for f in flags)
    served = []
    serve_once = network_gui.serve_once

    def recording_serve_once(render_fn, source_path):
        def rf(c, s):
            served.append(trainer.iteration)
            return render_fn(c, s)
        return serve_once(rf, source_path)

    monkeypatch.setattr(network_gui, "serve_once", recording_serve_once)
    verify = trainer.dataset_args.source_path
    frame = W * H * 3 + 4 + len(verify)
    replies, connected = [], threading.Event()
    with viewer_listener(network_gui) as port:
        def client():
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=TIMEOUT) as s:
                s.sendall(msgs)
                connected.set()
                replies.extend(recv_exact(s, frame) for _ in flags)

        t = threading.Thread(target=client)
        t.start()
        assert connected.wait(TIMEOUT)     # the first step accepts it
        for _ in range(20):
            trainer.step()
            if len(served) == len(flags):
                break
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        trainer.step()                     # the viewer hung up: trains on
        assert network_gui.conn is None
    assert served == [1, 2, 3, 3, 3, 3]
    assert trainer.iteration == 4 and len(replies) == len(flags)


def test_train_cli_serves_the_viewer(tmp_path):
    """`python -m ...train --method 3dgs` without --disable_viewer listens
    on --ip/--port (port 0 here) and serves a viewer's frame from its
    training loop."""
    W, H = 32, 24
    cloud = testing.make_gaussian_cloud(7, 100, extent=0.9,
                                        scale_range=(0.05, 0.15))
    scene = testing.write_blender_scene(str(tmp_path / "scene"), n_train=2,
                                        n_test=1, width=32, cloud=cloud,
                                        init_points=60)
    cam = testing.make_orbit_cameras(1, radius=6.0, width=W,
                                     height_px=H)[0]
    reply = {}

    def client():
        end = time.time() + TIMEOUT
        while network_gui.listener is None and time.time() < end:
            time.sleep(0.001)
        port = network_gui.listener.getsockname()[1]
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=TIMEOUT) as s:
            s.sendall(testing.viewer_message(cam, train=True))
            reply["img"] = recv_exact(s, W * H * 3)
            n = int.from_bytes(recv_exact(s, 4), "little")
            reply["verify"] = recv_exact(s, n).decode("ascii")

    t = threading.Thread(target=client)
    stdout = sys.stdout
    t.start()
    try:
        train_cli.main(["-s", scene, "-m", str(tmp_path / "out"), "--method",
                        "3dgs", "--device", "cpu", "--iterations", "30",
                        "--quiet", "--ip", "127.0.0.1", "--port", "0",
                        "--test_iterations", "30"])
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finally:
        sys.stdout = stdout                 # safe_state wraps it
        close_viewer(network_gui)
    assert reply["verify"] == scene
    assert np.frombuffer(reply["img"], np.uint8).max() > 0
