"""Reflection-based CLI parameter groups + cfg_args round-trip.

Same three config surfaces as the reference (`arguments/__init__.py:19-145`)
so existing launch commands and harness YAMLs run unchanged:
  1. ParamGroups: defaults are instance attributes; a leading underscore adds
     a one-letter shorthand and marks the field for the fill-none sentinel.
  2. `cfg_args`: train writes `Namespace(...)` repr into the model dir;
     render/metrics eval() it back and overlay CLI args.
  3. The benchmark harness whitelists flags per model via its YAML arg_map.

Method-specific extras (FSGS pseudo-view schedule, DNGaussian neural LRs,
mult-dwtgs NIR) are merged into OptimizationParams by `method=`.

The port's copy of `sparse_view_3dgs_pack_tpu/config.py`, so that its CLIs
read and write the same flags and `cfg_args`.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser, Namespace


class GroupParams:
    pass


class ParamGroup:
    def __init__(self, parser: ArgumentParser, name: str, fill_none=False):
        group = parser.add_argument_group(name)
        for key, value in vars(self).items():
            shorthand = key.startswith("_")
            if shorthand:
                key = key[1:]
            t = type(value)
            default = None if fill_none else value
            flags = ["--" + key] + (["-" + key[0]] if shorthand else [])
            if t is bool:
                group.add_argument(*flags, default=default,
                                   action="store_true")
            else:
                group.add_argument(*flags, default=default, type=t)

    def extract(self, args) -> GroupParams:
        g = GroupParams()
        for k, v in vars(args).items():
            if k in vars(self) or ("_" + k) in vars(self):
                setattr(g, k, v)
        return g


class ModelParams(ParamGroup):
    def __init__(self, parser, sentinel=False):
        self.sh_degree = 3
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._depths = ""
        self._resolution = -1
        self._white_background = False
        self.train_test_exp = False
        self.data_device = "tpu"
        self.eval = False
        self.n_views = 0
        self.point_cloud_type = "dense"
        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


class PipelineParams(ParamGroup):
    def __init__(self, parser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        self.antialiasing = False
        # TPU rasterizer capacity knobs (static-shape buckets; auto-grown)
        self.max_pairs = 0          # 0 → auto
        self.max_per_tile = 0       # 0 → auto
        self.tile_batch = 64
        super().__init__(parser, "Pipeline Parameters")


_BASE_OPT = dict(
    iterations=30_000,
    position_lr_init=0.00016,
    position_lr_final=0.0000016,
    position_lr_delay_mult=0.01,
    position_lr_max_steps=30_000,
    feature_lr=0.0025,
    opacity_lr=0.025,
    scaling_lr=0.005,
    rotation_lr=0.001,
    exposure_lr_init=0.01,
    exposure_lr_final=0.001,
    exposure_lr_delay_steps=0,
    exposure_lr_delay_mult=0.0,
    percent_dense=0.01,
    lambda_dssim=0.2,
    densification_interval=100,
    opacity_reset_interval=3000,
    densify_from_iter=500,
    densify_until_iter=15_000,
    densify_grad_threshold=0.0002,
    depth_l1_weight_init=1.0,
    depth_l1_weight_final=0.01,
    random_background=False,
    optimizer_type="default",
)

_DWT_OPT = dict(
    dwt_enable=True,
    dwt_weight=0.5,
    dwt_ll1_weight=1.0,
    dwt_lh1_weight=1.0,
    dwt_hl1_weight=1.0,
    dwt_hh1_weight=0.0,
    dwt_ll2_weight=0.0,
    dwt_lh2_weight=0.0,
    dwt_hl2_weight=0.0,
    dwt_hh2_weight=0.0,
    patch_dwt_enable=True,
    patch_dwt_weight=0.1,
    patch_size=128,
    patch_percentile=0.2,
    patch_dwt_lh1_weight=1.0,
    patch_dwt_hl1_weight=1.0,
)

# FSGS optimisation defaults (reference `FSGS/arguments/__init__.py:76-99`)
_FSGS_OPT = dict(
    iterations=10_000,
    position_lr_max_steps=10_000,
    densify_until_iter=10_000,
    depth_weight=0.05,
    depth_pseudo_weight=0.5,
    sample_pseudo_interval=10,
    start_sample_pseudo=2000,
    end_sample_pseudo=9500,
    dist_thres=10.0,
    proximity_until_iter=2000,
)

# DNGaussian extras (reference `DNGaussian/arguments/__init__.py:90-108`)
_DNG_OPT = dict(
    iterations=6000,
    position_lr_max_steps=6000,
    neural_grid_lr_init=0.05,
    neural_grid_lr_final=0.005,
    neural_net_lr_init=0.002,
    neural_net_lr_final=0.0002,
    error_tolerance=0.01,
    hard_depth_start=0,
    soft_depth_start=9999,
    shape_pena=0.002,
    scale_pena=0.005,
    opa_pena=0.01,
    depth_patch_size=17,
    lambda_depth=1.0,
    lambda_smooth=0.0,
    near_prune_dist=0.0,
    # 0 → SH-color fallback model (reference `gaussian_model_sh.py` +
    # `render_sh` paths); 1 → hash-grid neural color/opacity field
    use_neural=1,
)

# mult-dwtgs extras (reference `mult-dwtgs/arguments/__init__.py:61-64`)
_NIR_OPT = dict(
    use_nir=False,
    nir_weight=0.5,
    nir_degree=0,
    nir_albedo_lr=0.0025,
    nir_gain_lr=0.001,
)

METHOD_OPTS = {
    "3dgs": {**_BASE_OPT, **_DWT_OPT, "dwt_enable": False,
             "patch_dwt_enable": False},
    "lgdwt": {**_BASE_OPT, **_DWT_OPT},
    "fsgs": {**_BASE_OPT, **_DWT_OPT, "dwt_enable": False,
             "patch_dwt_enable": False, **_FSGS_OPT},
    "dngaussian": {**_BASE_OPT, **_DWT_OPT, "dwt_enable": False,
                   "patch_dwt_enable": False, **_DNG_OPT},
    "mult-dwtgs": {**_BASE_OPT, **_DWT_OPT, **_NIR_OPT, "use_nir": True},
}


class OptimizationParams(ParamGroup):
    def __init__(self, parser, method: str = "lgdwt"):
        for k, v in METHOD_OPTS[method].items():
            setattr(self, k, v)
        super().__init__(parser, "Optimization Parameters")


def get_combined_args(parser: ArgumentParser, cmdline=None) -> Namespace:
    """Overlay CLI args on the model dir's `cfg_args` snapshot (reference
    `arguments/__init__.py:125-145`)."""
    args_cmdline = parser.parse_args(
        cmdline if cmdline is not None else sys.argv[1:])
    cfgfile_string = "Namespace()"
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        with open(cfgfilepath) as f:
            print(f"Config file found: {cfgfilepath}")
            cfgfile_string = f.read()
    except (TypeError, FileNotFoundError):
        pass
    args_cfgfile = eval(cfgfile_string)  # noqa: S307 — reference contract
    merged = vars(args_cfgfile).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def write_cfg_args(model_path: str, args: Namespace) -> None:
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))
