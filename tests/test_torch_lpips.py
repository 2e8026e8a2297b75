"""Port parity for LPIPS (`metrics/lpips.py`) and the LPIPS keys of the
metrics CLI: the same synthetic npz handed to both packages through
``LPIPS_WEIGHTS_NPZ``, each backbone at 33×47, and the CLI's
`results.json` / `per_view.json` keys against root `metrics.py:69-85`."""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch.metrics import __main__ as metrics_cli
from sparse_view_3dgs_pack_tpu_torch.train.loop import (evaluate_cameras,
                                                        format_eval)
from sparse_view_3dgs_pack_tpu_torch.utils import image_io
import torch_port  # noqa: F401  (one intra-op thread)

# the packages' `metrics.lpips` attribute is the function: take the modules
jax_lpips = importlib.import_module("sparse_view_3dgs_pack_tpu.metrics.lpips")
port_lpips = importlib.import_module(
    "sparse_view_3dgs_pack_tpu_torch.metrics.lpips")

H, W = 33, 47
# relative: both packages run the same float32 convolutions, their sums in
# another order
LPIPS_RTOL = 1e-5


def _conv(rng, out_c, in_c, k):
    w = rng.normal(size=(out_c, in_c, k, k)) * np.sqrt(2.0 / (in_c * k * k))
    return w.astype(np.float32), (rng.normal(size=out_c) * 0.1).astype(
        np.float32)


def _synthetic_npz(path, net, seed=0):
    """Random weights in the converted-weights layout of `net`."""
    rng = np.random.default_rng(seed)
    out = {}
    if net == "squeeze":
        out["conv0"], out["bias0"] = _conv(rng, 64, 3, 3)
        in_c = 64
        for j, (sq, ex) in enumerate(port_lpips._SQUEEZE_FIRES):
            for part, (o, i, k) in (("squeeze", (sq, in_c, 1)),
                                    ("e1", (ex, sq, 1)), ("e3", (ex, sq, 3))):
                out[f"f{j}_{part}_w"], out[f"f{j}_{part}_b"] = _conv(
                    rng, o, i, k)
            in_c = 2 * ex
    else:
        cfg = (port_lpips._VGG_CFG if net == "vgg"
               else port_lpips._ALEX_CFG)
        in_c = 3
        for i, row in enumerate(cfg):
            k = 3 if net == "vgg" else row[1]
            out[f"conv{i}"], out[f"bias{i}"] = _conv(rng, row[0], in_c, k)
            in_c = row[0]
    for i, c in enumerate(port_lpips._CHANNELS[net]):
        out[f"lin{i}"] = rng.random((1, c, 1, 1)).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture
def weights(tmp_path, monkeypatch):
    for net in port_lpips.NET_TYPES:
        _synthetic_npz(str(tmp_path / f"lpips_{net}.npz"), net,
                       seed=len(net))
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "lpips_{net}.npz"))
    jax_lpips.reset_lpips_cache()
    port_lpips.reset_lpips_cache()
    yield
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ")
    jax_lpips.reset_lpips_cache()
    port_lpips.reset_lpips_cache()


def _images(seed=1):
    rng = np.random.default_rng(seed)
    a = rng.random((H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net", port_lpips.NET_TYPES)
def test_lpips_matches_jax_on_the_same_weights(weights, net):
    a, b = _images()
    want = float(jax_lpips.lpips(jnp.asarray(a), jnp.asarray(b), net))
    got = float(port_lpips.lpips(torch.tensor(a), torch.tensor(b), net))
    assert want > 0
    assert abs(got - want) <= LPIPS_RTOL * want, (got, want)
    assert port_lpips.lpips_backend(net) == jax_lpips.lpips_backend(net) \
        != "random-features-proxy"
    assert float(port_lpips.lpips(torch.tensor(a), torch.tensor(a),
                                  net)) == 0.0


def test_lpips_proxy_without_weights(monkeypatch, tmp_path):
    """No npz: a seeded proxy, tagged as one, the same value each time;
    an unknown backbone raises."""
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "missing.npz"))
    port_lpips.reset_lpips_cache()
    a, b = _images(2)
    for net in port_lpips.NET_TYPES:
        assert port_lpips.lpips_backend(net) == "random-features-proxy"
        assert port_lpips.lpips_is_proxy(net)
        v1 = float(port_lpips.lpips(torch.tensor(a), torch.tensor(b), net))
        port_lpips.reset_lpips_cache()
        v2 = float(port_lpips.lpips(torch.tensor(a), torch.tensor(b), net))
        assert v1 == v2 and v1 > 0
    with pytest.raises(NotImplementedError):
        port_lpips.lpips(torch.tensor(a), torch.tensor(b), "resnet")
    port_lpips.reset_lpips_cache()


def _model_dir(root, n=3):
    rng = np.random.default_rng(3)
    d = root / "model" / "test" / "ours_10"
    for sub in ("renders", "gt"):
        os.makedirs(d / sub)
    for i in range(n):
        g = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        r = np.clip(g.astype(np.int32) + rng.integers(-20, 20, g.shape), 0,
                    255).astype(np.uint8)
        image_io.write_png(str(d / "gt" / f"{i:05d}.png"), g)
        image_io.write_png(str(d / "renders" / f"{i:05d}.png"), r)
    return str(root / "model")


@pytest.mark.parametrize("real", [False, True])
def test_metrics_cli_writes_the_lpips_keys(tmp_path, monkeypatch, real):
    """`results.json` holds `LPIPS` (real weights) or `LPIPS_proxy`, plus
    `LPIPS_backend`; `per_view.json` the same LPIPS key per view; the
    value is the mean of `lpips` over the views."""
    if real:
        _synthetic_npz(str(tmp_path / "lpips_vgg.npz"), "vgg")
        monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path /
                                                     "lpips_vgg.npz"))
    else:
        monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "none.npz"))
    port_lpips.reset_lpips_cache()
    model = _model_dir(tmp_path)
    assert metrics_cli.main(["-m", model, "--device", "cpu"]) == 0
    with open(os.path.join(model, "results.json")) as f:
        res = json.load(f)["ours_10"]
    with open(os.path.join(model, "per_view.json")) as f:
        per = json.load(f)["ours_10"]
    key = "LPIPS" if real else "LPIPS_proxy"
    assert set(res) == {"SSIM", "PSNR", key, "LPIPS_backend"}
    assert res["LPIPS_backend"] == ("vgg16-pretrained" if real
                                    else "random-features-proxy")
    assert set(per) == {"SSIM", "PSNR", key}
    assert sorted(per[key]) == ["00000.png", "00001.png", "00002.png"]
    assert res[key] == pytest.approx(np.mean(list(per[key].values())),
                                     rel=1e-6)
    assert res[key] > 0
    port_lpips.reset_lpips_cache()


@pytest.mark.parametrize("real", [False, True])
def test_evaluate_cameras_reports_lpips_only_from_real_weights(
        tmp_path, monkeypatch, real):
    """The in-training report gains `lpips` only when the weights are not
    a proxy (JAX `train/loop.py:84-95`)."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.models.gaussians import \
        GaussianModel
    if real:
        _synthetic_npz(str(tmp_path / "lpips_vgg.npz"), "vgg")
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "lpips_vgg.npz"))
    port_lpips.reset_lpips_cache()
    c = testing.make_gaussian_cloud(0, 60, extent=0.8)
    f = c["features"]
    model = GaussianModel(c["xyz"], f[:, :1], f[:, 1:], c["scales"],
                          c["quats"], c["opacity"])
    cams = testing.make_orbit_cameras(2, radius=3.0, width=32, height_px=24)
    for cam in cams:
        cam.image = np.full((24, 32, 3), 0.5, np.float32)
    stats = evaluate_cameras(model, cams, [0.0, 0.0, 0.0], 0)
    assert ("lpips" in stats) == real
    assert ("LPIPS" in format_eval(stats)) == real
    if real:
        assert stats["lpips"] > 0
    port_lpips.reset_lpips_cache()
