"""sparse_view_3dgs_pack_tpu_torch — the PyTorch/CUDA port of the 3DGS /
LGDWT-GS training and render paths.

A second package beside the JAX reference `sparse_view_3dgs_pack_tpu`, with
the same module paths so each module's counterpart is easy to find. It
imports `torch` and nothing of jax or the JAX package: the host-only
modules it needs from there (`config.py`, `data/cameras.py`,
`data/colmap.py`, `data/ply.py`, `utils/graphics.py`, the generators of
`testing.py`) are copied under the same path.

Layout:
  device.py     explicit torch.device resolution (no silent CPU fallback)
  ops/          projection, tile binning, blending math, the dense oracle,
                the exact 3-NN scale init, and the tile rasterizer: forward
                and backward hand-written CUDA kernels (`csrc/raster_fwd.cu`,
                `csrc/raster_bwd.cu`) beside their plain PyTorch versions,
                joined by a `torch.autograd.Function`; the probe kernels
                (`csrc/probes.cu`, `ops/probes.py`)
  probes/       `python -m ...probes.prims|fwd_bisect`: bisect a rasterizer
                fault on the card down to its primitive
  models/       GaussianModel (nn.Module), create_from_pcd, PLY IO, the JAX
                state bridge
  renderer.py   render_core (inference and training) / render
  losses/       L1, SSIM, Haar-DWT subbands, ELF patch DWT, depth L1, the
                FSGS, DNGaussian and NIR losses
  train/        step, per-group Adam, densification, Trainer, recipes,
                checkpoints, the debug snapshot, the FSGS, DNGaussian and
                mult-dwtgs loops;
                `python -m sparse_view_3dgs_pack_tpu_torch.train`
                (`...train_nir`: `--method mult-dwtgs`)
  data/, scene.py   scene readers, cameras, Scene (load and init/save);
                `data/native.py` the optional `fastio` readers
  preprocessing/  COLMAP, few-shot, LLFF poses, depth scales, greenhouse
                TIFFs (host only); `python -m ...convert`
  metrics/      SSIM and PSNR; `python -m ...metrics` is the CLI
  render.py     `python -m sparse_view_3dgs_pack_tpu_torch.render`
  viewer/       the SIBR remote-viewer bridge the 3dgs / lgdwt trainer serves
  parallel/     view data parallelism over torch.distributed (NCCL, gloo;
                the train CLI's `--data_parallel`) and the band-parallel
                render (the render CLI's `--tile_parallel`)
  benchmark/    the `gs_benchmark` harness: methods trained, rendered and
                scored side by side through the CLIs (`python -m
                ...benchmark.cli runall`); `full_eval.py` the standard
                benchmark sets
"""

__version__ = "0.2.0"
