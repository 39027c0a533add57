"""Command line for texture synthesis on the GPU (the counterpart of
``optimaltextures_tpu/cli.py``, synthesis flags only).

Run: python -m optimaltextures_tpu_torch.cli --style style.jpg --size 512
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    p = argparse.ArgumentParser(
        prog="optex-torch",
        description="Texture synthesis by sliced optimal transport "
                    "(PyTorch/CUDA)")
    p.add_argument("--version", action="version",
                   version=f"optex-torch {__version__}")
    p.add_argument("-s", "--style", type=str, nargs="+", required=True,
                   help="style exemplar image")
    p.add_argument("--size", type=int, default=512, help="output size")
    p.add_argument("--passes", type=int, default=5,
                   help="loops over the VGG layer stack")
    p.add_argument("--iters", type=int, default=500,
                   help="total sliced-OT iteration budget")
    p.add_argument("--hist_mode", type=str, default="chol",
                   choices=["sym", "pca", "chol", "cdf", "sort"],
                   help="histogram matching strategy (cdf/sort: not ported)")
    p.add_argument("--style_scale", type=float, default=1.0,
                   help="style detail scale relative to the output")
    p.add_argument("--no_pca", action="store_true",
                   help="disable PCA feature reduction")
    p.add_argument("--no_multires", action="store_true",
                   help="disable multi-scale rendering")
    p.add_argument("--seed", type=int, default=None,
                   help="seeds every random draw, rotations included")
    p.add_argument("--output_dir", type=str, default="output/")
    p.add_argument("--depth", type=int, default=None,
                   help="max VGG depth (default: deepest available weights)")
    p.add_argument("--no_schedule_quirk", action="store_true",
                   help="fix the reference's [l-1] schedule indexing quirk")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--quiet", dest="verbose", action="store_false")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import api

    cfg = api.config_from_args(args)
    cfg.compat_schedule_quirk = not args.no_schedule_quirk
    _, seconds, paths = api.run_files(cfg, verbose=args.verbose,
                                      device=args.device)
    print("Took:", seconds)
    for path in paths:
        print("saved", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
