"""COLMAP conversion CLI of the port (the role of the root `convert.py`,
flag-compatible with the reference `gaussian-splatting/convert.py:1-124`):

    python -m sparse_view_3dgs_pack_tpu_torch.convert -s <scene>

runs the full reconstruction on `<scene>/input` images with the COLMAP
binary and lays out `images/` + `sparse/0` (+ resized pyramids with
`--resize`). Host only."""

from argparse import ArgumentParser

from .preprocessing.full_colmap import run_full_colmap


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or "colmap"
    run_full_colmap(args.source_path, "input", colmap, args.camera,
                    use_gpu=not args.no_gpu,
                    skip_matching=args.skip_matching, resize=args.resize)


if __name__ == "__main__":
    main()
