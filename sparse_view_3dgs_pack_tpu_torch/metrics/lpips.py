"""LPIPS with VGG16, AlexNet and SqueezeNet backbones and linear heads.

Counterpart of `sparse_view_3dgs_pack_tpu/metrics/lpips.py` (reference
`lpipsPyTorch/modules/networks.py:12-89`, `modules/lpips.py`,
`lpipsPyTorch/__init__.py:7-21`), on NCHW tensors. The layer tables below
are copies of the JAX module's. Input scaling is the reference's: its
`BaseNet.z_score` applies `(x - mean) / std` to the [0, 1] images as they
are, with no rescale to [-1, 1] first.

Weights are read from the same npz layout as the JAX package
(`conv{i}`/`bias{i}` in torch's (out, in, kh, kw) layout, the fire entries
`f{j}_{part}_w|b` of SqueezeNet, the heads `lin{i}`), found through
``LPIPS_WEIGHTS_NPZ`` (a path, or a path with ``{net}`` in it) or as
``lpips_{net}.npz`` beside this file. Without such a file the same
architecture runs with He-initialised weights drawn from a seeded
`torch.Generator` and uniform heads: a deterministic perceptual proxy,
tagged ``random-features-proxy`` by `lpips_backend()`. The JAX proxy draws
its weights from `jax.random`, which this package cannot reproduce, so the
two packages' proxy values differ; with the same npz they agree.

The convolutions are `torch.nn.functional.conv2d`, as the JAX package
leaves them to XLA; on a card they run in full float32 (cuDNN's TF32 off).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature stack: (out_channels, pool_before) per 3x3 conv
_VGG_CFG = [(64, False), (64, False),
            (128, True), (128, False),
            (256, True), (256, False), (256, False),
            (512, True), (512, False), (512, False),
            (512, True), (512, False), (512, False)]
# LPIPS taps after convs 1, 3, 6, 9, 12 (relu1_2 … relu5_3)
_VGG_TAPS = [1, 3, 6, 9, 12]

# AlexNet features: (out_c, kernel, stride, padding, pool_before); a tap
# after every relu
_ALEX_CFG = [(64, 11, 4, 2, False),
             (192, 5, 1, 2, True),
             (384, 3, 1, 1, True),
             (256, 3, 1, 1, False),
             (256, 3, 1, 1, False)]

# SqueezeNet1_1 fire modules: (squeeze_c, expand_c), out = 2 * expand_c;
# ceil-mode 3/2 pools before fires 0, 2, 4; taps after conv0's relu and
# after fires 1, 3, 4, 5, 6, 7
_SQUEEZE_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128),
                  (48, 192), (48, 192), (64, 256), (64, 256)]
_SQUEEZE_POOL_BEFORE = {0, 2, 4}
_SQUEEZE_TAP_FIRES = [1, 3, 4, 5, 6, 7]

_CHANNELS = {"vgg": [64, 128, 256, 512, 512],
             "alex": [64, 192, 384, 256, 256],
             "squeeze": [64, 128, 256, 384, 384, 512, 512]}

_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)

NET_TYPES = ("vgg", "alex", "squeeze")
PROXY = "random-features-proxy"
_PRETRAINED = {"vgg": "vgg16-pretrained", "alex": "alexnet-pretrained",
               "squeeze": "squeezenet-pretrained"}
_PROXY_SEEDS = {"vgg": 1234, "alex": 2345, "squeeze": 3456}


def _weights_path(net_type: str):
    cand = os.environ.get("LPIPS_WEIGHTS_NPZ")
    if cand:
        cand = cand.replace("{net}", net_type)
        if os.path.exists(cand):
            return cand
    local = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         f"lpips_{net_type}.npz")
    return local if os.path.exists(local) else None


def _he_conv(gen, in_c, out_c, k):
    """(out, in, k, k) He-normal weight and a zero bias."""
    w = torch.randn((out_c, in_c, k, k), generator=gen) * np.sqrt(
        2.0 / (in_c * k * k))
    return w, torch.zeros(out_c)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@lru_cache(maxsize=3)
def _load_weights(net_type: str):
    """→ (convs, lins, backend tag) on the CPU. `convs` is a list of
    (weight, bias); for SqueezeNet, conv0 followed by each fire's squeeze,
    e1 and e3 in turn."""
    if net_type not in NET_TYPES:
        raise NotImplementedError("choose net_type from [alex, squeeze, vgg].")
    path = _weights_path(net_type)
    n_lins = len(_CHANNELS[net_type])
    if path:
        data = np.load(path)
        if net_type == "squeeze":
            keys = [("conv0", "bias0")] + [
                (f"f{j}_{part}_w", f"f{j}_{part}_b")
                for j in range(len(_SQUEEZE_FIRES))
                for part in ("squeeze", "e1", "e3")]
        else:
            n = len(_VGG_CFG if net_type == "vgg" else _ALEX_CFG)
            keys = [(f"conv{i}", f"bias{i}") for i in range(n)]
        convs = [(_t(data[w]), _t(data[b])) for w, b in keys]
        lins = [_t(data[f"lin{i}"][:, :, 0, 0][0]) for i in range(n_lins)]
        return convs, lins, _PRETRAINED[net_type]

    gen = torch.Generator().manual_seed(_PROXY_SEEDS[net_type])
    if net_type == "vgg":
        shapes = [(i, o, 3) for i, (o, _) in zip(
            [3] + [c for c, _ in _VGG_CFG[:-1]], _VGG_CFG)]
    elif net_type == "alex":
        shapes = [(i, o, k) for i, (o, k, _, _, _) in zip(
            [3] + [c[0] for c in _ALEX_CFG[:-1]], _ALEX_CFG)]
    else:
        shapes, in_c = [(3, 64, 3)], 64
        for sq_c, ex_c in _SQUEEZE_FIRES:
            shapes += [(in_c, sq_c, 1), (sq_c, ex_c, 1), (sq_c, ex_c, 3)]
            in_c = 2 * ex_c
    convs = [_he_conv(gen, i, o, k) for i, o, k in shapes]
    lins = [torch.ones(c) / c for c in _CHANNELS[net_type]]
    return convs, lins, PROXY


_ON_DEVICE: dict = {}


def _weights_on(net_type: str, device: torch.device):
    key = (net_type, str(device))
    if key not in _ON_DEVICE:
        convs, lins, _ = _load_weights(net_type)
        _ON_DEVICE[key] = ([(w.to(device), b.to(device)) for w, b in convs],
                           [lin.to(device) for lin in lins])
    return _ON_DEVICE[key]


def lpips_backend(net_type: str = "vgg") -> str:
    return _load_weights(net_type)[2]


def lpips_is_proxy(net_type: str = "vgg") -> bool:
    return lpips_backend(net_type) == PROXY


def reset_lpips_cache() -> None:
    """Drop the cached weights, so that a changed ``LPIPS_WEIGHTS_NPZ`` is
    read again."""
    _load_weights.cache_clear()
    _ON_DEVICE.clear()


def _z_score(x):
    """(H, W, 3) in [0, 1] → (1, 3, H, W), the reference's z-score."""
    mean = x.new_tensor(_MEAN)
    std = x.new_tensor(_STD)
    return ((x - mean) / std).permute(2, 0, 1)[None]


def _vgg_features(h, convs):
    feats = []
    for i, ((w, b), (_, pool)) in enumerate(zip(convs, _VGG_CFG)):
        if pool:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(F.conv2d(h, w, b, padding=1))
        if i in _VGG_TAPS:
            feats.append(h)
    return feats


def _alex_features(h, convs):
    feats = []
    for (w, b), (_, _, stride, pad, pool) in zip(convs, _ALEX_CFG):
        if pool:
            h = F.max_pool2d(h, 3, 2)
        h = F.relu(F.conv2d(h, w, b, stride=stride, padding=pad))
        feats.append(h)
    return feats


def _squeeze_features(h, convs):
    w0, b0 = convs[0]
    h = F.relu(F.conv2d(h, w0, b0, stride=2))
    feats = [h]
    for j in range(len(_SQUEEZE_FIRES)):
        (sw, sb), (e1w, e1b), (e3w, e3b) = convs[1 + 3 * j:4 + 3 * j]
        if j in _SQUEEZE_POOL_BEFORE:
            h = F.max_pool2d(h, 3, 2, ceil_mode=True)
        sq = F.relu(F.conv2d(h, sw, sb))
        h = torch.cat([F.relu(F.conv2d(sq, e1w, e1b)),
                       F.relu(F.conv2d(sq, e3w, e3b, padding=1))], dim=1)
        if j in _SQUEEZE_TAP_FIRES:
            feats.append(h)
    return feats


_FEATURES = {"vgg": _vgg_features, "alex": _alex_features,
             "squeeze": _squeeze_features}


def _distance(fx, fy, lins):
    total = fx[0].new_zeros(())
    for f1, f2, lin in zip(fx, fy, lins):
        n1 = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=1,
                                                       keepdim=True),
                              min=1e-10)
        n2 = f2 / torch.clamp(torch.linalg.vector_norm(f2, dim=1,
                                                       keepdim=True),
                              min=1e-10)
        total = total + (((n1 - n2) ** 2) * lin[None, :, None, None]).sum(
            1).mean()
    return total


@torch.no_grad()
def lpips(img1, img2, net_type: str = "vgg") -> torch.Tensor:
    """img: (H, W, 3) float in [0, 1], tensors on one device (or arrays,
    taken to the CPU). net_type: 'vgg' | 'alex' | 'squeeze' (the reference
    metrics.py passes 'vgg'). Returns a 0-d float32 tensor."""
    if net_type not in _FEATURES:
        raise NotImplementedError("choose net_type from [alex, squeeze, vgg].")
    x = torch.as_tensor(img1, dtype=torch.float32)
    y = torch.as_tensor(img2, dtype=torch.float32, device=x.device)
    convs, lins = _weights_on(net_type, x.device)
    feats = _FEATURES[net_type]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return _distance(feats(_z_score(x), convs), feats(_z_score(y), convs),
                         lins)
