"""Adam over every tensor of one optimizer call as one CUDA kernel launch.

`adam_multi` launches `csrc/adam.cu` on CUDA tensors and raises on any
other device or on a tensor it does not take (float32, contiguous, the
gradient and the moments shaped as the parameter); there is no fallback.
Its plain version is `train/optim.py::adam_update_torch` (and
`exposure_adam_update_torch`), which `adam_update` runs on CPU tensors.
`plan` is the host side of a launch: the checks and the table the C entry
packs into the kernel's arguments. `adam_multi.launches` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from ._build import load

CHUNK = 8192          # values a block, a multiple of 4
MAX_TENSORS = 48      # as csrc/adam.cu's kMaxTensors
MAX_NUMEL = 2 ** 31 - 2 ** 16   # the kernel's int indices, a chunk's room


class Plan(NamedTuple):
    """One launch's table: per tensor the p, g, m and v pointers (in turn
    in `ptrs`), its values, its row width, whether all four pointers are
    16-B aligned (float4 loads) and its lr; `first` each tensor's first
    block, then the number of blocks."""
    ptrs: list
    numel: list
    width: list
    vec: list
    lr: list
    first: list


def plan(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
         ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
         lrs: Sequence[float],
         visibility: Optional[torch.Tensor] = None) -> Plan:
    """The table of one launch over the tensors `ps` (gradients `gs`,
    moments `ms`, `vs`, learning rates `lrs`), after checking that the
    kernel takes them: float32, contiguous, each shaped as its parameter,
    all on one device; `visibility`, where given, a contiguous (N,) bool
    with N the first dimension of every parameter."""
    count = len(ps)
    if not 1 <= count <= MAX_TENSORS or not (
            len(gs) == len(ms) == len(vs) == len(lrs) == count):
        raise ValueError(f"adam: 1 to {MAX_TENSORS} tensors, each with a "
                         f"gradient, two moments and an lr; got {count}")
    dev = ps[0].device
    if visibility is not None and (
            visibility.dtype != torch.bool or visibility.ndim != 1
            or not visibility.is_contiguous() or visibility.device != dev):
        raise ValueError(f"adam: visibility must be a contiguous (N,) bool "
                         f"tensor on {dev}, got {visibility.dtype} "
                         f"{tuple(visibility.shape)} on {visibility.device}")
    out = Plan([], [], [], [], [], [0])
    for i, group in enumerate(zip(ps, gs, ms, vs)):
        shape = group[0].shape
        for name, t in zip("pgmv", group):
            if (t.dtype != torch.float32 or t.shape != shape
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(
                    f"adam: tensor {i} {name} must be contiguous float32 "
                    f"{tuple(shape)} on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}"
                    + ("" if t.is_contiguous() else " (not contiguous)"))
        n = group[0].numel()
        if n > MAX_NUMEL:
            raise ValueError(f"adam: tensor {i} has {n} values, more than "
                             f"{MAX_NUMEL}")
        rows = shape[0] if len(shape) else 1
        if visibility is not None and rows != visibility.shape[0]:
            raise ValueError(f"adam: visibility has {visibility.shape[0]} "
                             f"rows, tensor {i} {tuple(shape)}")
        ptrs = [t.data_ptr() for t in group]
        out.ptrs.extend(ptrs)
        out.numel.append(n)
        out.width.append(n // rows if rows else 0)
        out.vec.append(int(all(p % 16 == 0 for p in ptrs)))
        out.lr.append(float(lrs[i]))
        out.first.append(out.first[-1] + -(-n // CHUNK))
    return out


def _lib():
    lib = load("adam")
    if not getattr(lib, "adam_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adam_multi.argtypes = ([ci, vp, vp, vp, vp, ci, vp, ci]
                                   + [cf] * 5 + [ci, vp])
        lib.adam_multi.restype = ci
        lib.adam_typed = True
    return lib


def adam_multi(ps, gs, ms, vs, lrs, step: int, beta1: float, beta2: float,
               eps: float, visibility: Optional[torch.Tensor] = None,
               square_first: bool = True) -> None:
    """One Adam step of every tensor of `ps`, in place on `ps`, `ms` and
    `vs`, in one launch: m ← β1·m + (1 − β1)·g, v ← β2·v + (1 − β2)·(g·g)
    (((1 − β2)·g)·g where not `square_first`), p ← p − lr·(m / bc1) /
    (√(v / bc2) + ε), with bc = 1 − β^step computed on the card. Rows
    outside `visibility` are neither read nor written."""
    pl = plan(ps, gs, ms, vs, lrs, visibility)
    dev = ps[0].device
    if dev.type != "cuda":
        raise ValueError(f"adam_multi launches a CUDA kernel; tensors on "
                         f"{dev}")
    count = len(pl.numel)
    ints = [x for row in zip(pl.numel, pl.width, pl.vec) for x in row]
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.adam_multi(
            count, (ctypes.c_uint64 * len(pl.ptrs))(*pl.ptrs),
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * count)(*pl.lr),
            (ctypes.c_int * (count + 1))(*pl.first), CHUNK,
            None if visibility is None else visibility.data_ptr(), step,
            beta1, 1 - beta1, beta2, 1 - beta2, eps, int(square_first),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adam_multi launch failed: cudaError {err}")
    adam_multi.launches += 1


adam_multi.launches = 0
