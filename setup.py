import pathlib

from setuptools import Extension, find_packages, setup
from setuptools.command.build_ext import build_ext


class OptionalNativeBuild(build_ext):
    """Build the native scene-IO accelerator alongside the package, but keep
    the install usable without it: `data/native.py` degrades to the pure-
    Python readers when `fastio` is absent. The TPU-native analogue of the
    reference's auto-install of its CUDA submodules at build time
    (`fs3dgs_benchmark/post_install.py:6-44`) — here there is exactly one
    host-side native component, so a failed toolchain is a warning, not a
    broken install."""

    def run(self):
        try:
            super().run()
        except Exception as exc:  # missing compiler, headers, ...
            print(f"[sparse_view_3dgs_pack_tpu] WARNING: native fastio "
                  f"extension build failed ({exc!r}); falling back to the "
                  f"pure-Python COLMAP/PLY readers.")


_NATIVE_SRC = pathlib.Path(__file__).parent / "native" / "fastio.cpp"

setup(
    name="sparse_view_3dgs_pack_tpu",
    version="0.1.0",
    description=("TPU-native sparse-view 3D Gaussian Splatting framework "
                 "(JAX/XLA/Pallas): LGDWT-GS, vanilla 3DGS, FSGS, DNGaussian "
                 "and multispectral mult-dwtgs plus the fs3dgs benchmark "
                 "harness"),
    packages=find_packages(include=["sparse_view_3dgs_pack_tpu",
                                    "sparse_view_3dgs_pack_tpu.*",
                                    "sparse_view_3dgs_pack_tpu_torch",
                                    "sparse_view_3dgs_pack_tpu_torch.*"]),
    package_data={"sparse_view_3dgs_pack_tpu_torch.benchmark":
                  ["config.yaml"]},
    python_requires=">=3.10",
    ext_modules=[Extension(
        "fastio", [str(_NATIVE_SRC)],
        extra_compile_args=["-O3", "-std=c++17"],
    )] if _NATIVE_SRC.exists() else [],
    cmdclass={"build_ext": OptionalNativeBuild},
    install_requires=["jax", "numpy", "pyyaml", "pillow", "matplotlib"],
    entry_points={
        "console_scripts": [
            "gs_benchmark = sparse_view_3dgs_pack_tpu.benchmark.cli:main",
            "gs_benchmark_torch = "
            "sparse_view_3dgs_pack_tpu_torch.benchmark.cli:main",
        ],
    },
)
