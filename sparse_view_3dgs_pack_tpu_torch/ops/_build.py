"""Build and load the hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled at first use by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, under
`build/kernels/` at the root of the checkout, and loaded with ctypes. The
library name carries a hash of the source, of the `csrc/` headers it
includes and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per source: the probes, the k-NN search, the projection, Adam and the
# hash grid round every f32 operation on its own, as their plain PyTorch
# versions do, so that the two can agree bit for bit
SOURCE_FLAGS = {"probes": ("--fmad=false",), "knn": ("--fmad=false",),
                "projection": ("--fmad=false",), "adam": ("--fmad=false",),
                "hashgrid": ("--fmad=false",)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are compiled from source at first use")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _headers(name: str) -> list[Path]:
    """The `csrc/` headers that `<name>.cu` includes (`#include "..."`),
    and theirs in turn."""
    found, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        text = todo.pop().read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            path = CSRC_DIR / inc
            if path not in found:
                found.append(path)
                todo.append(path)
    return sorted(found)


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes()
                   for p in [CSRC_DIR / f"{name}.cu", *_headers(name)])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile `csrc/<name>.cu` unless the library for this exact source
    exists. Returns the library path and nvcc's output ("" when nothing was
    built), which holds ptxas' register and spill report."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode})"
                           f":\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _loaded[name] = lib
        return lib
