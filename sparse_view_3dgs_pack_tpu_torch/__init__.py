"""sparse_view_3dgs_pack_tpu_torch — the PyTorch/CUDA port of the render path.

A second package beside the JAX reference `sparse_view_3dgs_pack_tpu`, with
the same module paths so each module's counterpart is easy to find. It
imports `torch` and never `jax`; host-only modules of the JAX package that
import no jax (`data/cameras.py`, `data/ply.py`, `data/colmap.py`,
`data/native.py`, `utils/graphics.py`, `config.py`, `testing.py`) are
imported from there, not copied.

Layout:
  device.py     explicit torch.device resolution (no silent CPU fallback)
  ops/          projection, tile binning, blending math, the dense oracle,
                and the forward rasterizer: a hand-written CUDA kernel
                (`csrc/raster_fwd.cu`) beside its plain PyTorch version
  models/       GaussianModel (nn.Module), PLY IO, the JAX weight bridge
  renderer.py   render_core / render (inference)
  data/         scene readers and camera loading without PIL/cv2
  losses/, metrics/   SSIM and PSNR; `python -m ...metrics` is the CLI
  render.py     `python -m sparse_view_3dgs_pack_tpu_torch.render`
"""

__version__ = "0.1.0"
