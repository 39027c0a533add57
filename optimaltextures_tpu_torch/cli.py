"""Command line for texture synthesis, style transfer, texture mixing and
color transfer on the GPU, tileable or not, on one or several GPUs (the
counterpart of ``optimaltextures_tpu/cli.py``).

Run: python -m optimaltextures_tpu_torch.cli --style style.jpg --size 512
     python -m optimaltextures_tpu_torch.cli --style style.jpg --tileable
     python -m optimaltextures_tpu_torch.cli --style a.jpg b.jpg --mixing_alpha 0.5
     python -m optimaltextures_tpu_torch.cli --style style.jpg --batch 8 --num_devices 4
     python -m optimaltextures_tpu_torch.cli --style a.jpg b.jpg --style_parallel --num_devices 2
     python -m optimaltextures_tpu_torch.cli --style style.jpg --size 2048 --spatial_devices 4
"""

from __future__ import annotations

import argparse
import contextlib
import os
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
                   help="style exemplar image (two or more: mixing)")
    p.add_argument("-c", "--content", type=str, default=None,
                   help="content image for style transfer")
    p.add_argument("--init", type=str, default=None,
                   help="starting pastiche image instead of noise")
    p.add_argument("--batch", type=int, default=1,
                   help="number of noise pastiches to synthesize at once")
    p.add_argument("--size", type=int, default=512, help="output size")
    p.add_argument("--out_width", type=int, default=None,
                   help="non-square synthesis width, a multiple of 32 (the "
                        "height is --size); synthesis only")
    p.add_argument("--passes", type=int, default=5,
                   help="loops over the VGG layer stack")
    p.add_argument("--iters", type=int, default=500,
                   help="total sliced-OT iteration budget")
    p.add_argument("--hist_mode", type=str, default="chol",
                   choices=["sym", "pca", "chol", "cdf", "sort"],
                   help="histogram matching strategy (sort = exact 1-D OT)")
    p.add_argument("--color_transfer", type=str, default=None,
                   choices=["lum", "opt"],
                   help="keep the content image's colors")
    p.add_argument("--content_strength", type=float, default=0.01)
    p.add_argument("--style_scale", type=float, default=1.0,
                   help="style detail scale relative to the output")
    p.add_argument("--mixing_alpha", type=float, default=0.5,
                   help="interpolation between 2 styles")
    p.add_argument("--mixing_weights", type=float, nargs="+", default=None,
                   help="one positive weight per style for 3+-style mixing "
                        "(default uniform); with 2 styles overrides "
                        "--mixing_alpha via the generalized blend")
    p.add_argument("--no_pca", action="store_true",
                   help="disable PCA feature reduction")
    p.add_argument("--no_multires", action="store_true",
                   help="disable multi-scale rendering")
    p.add_argument("--seed", type=int, default=None,
                   help="seeds every random draw, rotations included")
    p.add_argument("--output_dir", type=str, default="output/")
    p.add_argument("--depth", type=int, default=None,
                   help="max VGG depth (default: deepest available weights)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="shard --batch synthesis over this many GPUs, one "
                        "process each (exact joint statistics through "
                        "all-reduces; with --device cpu, gloo ranks on the "
                        "CPU)")
    p.add_argument("--spatial_devices", type=int, default=1,
                   help="shard ONE image's height axis over this many "
                        "GPUs, one process each (every 3x3 conv on halo rows "
                        "from the neighbours, exact global statistics; every "
                        "pass size must divide by N * 2^(depth-1)); with "
                        "--num_devices, a num_devices x spatial_devices grid "
                        "(--batch divisible by --num_devices)")
    p.add_argument("--style_parallel", action="store_true",
                   help="synthesize ONE texture per --style image instead "
                        "of mixing (one style per GPU when --num_devices "
                        "matches the style count). With PCA, --pca_bucket 0 "
                        "(exact-k) is forced to 32: per-style ranks are "
                        "ragged; the bucketed math is still exact per style")
    p.add_argument("--tileable", action="store_true",
                   help="seamlessly tileable output: circular conv padding "
                        "and wrap-tap multires resizes on the pastiche path "
                        "(every pass size must divide by 2^(depth-1))")
    p.add_argument("--content_anchor", type=str, default="index",
                   choices=["index", "depth"],
                   help="depth<5 content-matching rule: 'index' = the "
                        "reference's literal l<=2 positions, 'depth' = "
                        "anchor at VGG depths >= 3 (identical at depth 5)")
    p.add_argument("--conv_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv stack compute dtype (bfloat16 = faster tensor "
                        "cores; statistics and OT stay float32)")
    p.add_argument("--pca_bucket", type=int, default=0,
                   help="round the PCA rank up to this bucket (0 = the exact "
                        "rank); the same result through zero-padded "
                        "eigenvectors and blockdiag rotations")
    p.add_argument("--pca_traced_k", action="store_true",
                   help="take the PCA rank on the device at the full channel "
                        "width: no spectrum is fetched to the host")
    p.add_argument("--batch_chunk", type=int, default=0,
                   help="run the codec in chunks of this many images (peak "
                        "memory follows the chunk, not the batch; moment "
                        "modes, synthesis; with --num_devices each GPU "
                        "chunks its own shard; 0 = off)")
    p.add_argument("--no_cov_prop", action="store_true",
                   help="run the moment modes' OT iterations one by one, "
                        "each recomputing the statistics from the data")
    p.add_argument("--no_schedule_quirk", action="store_true",
                   help="fix the reference's [l-1] schedule indexing quirk")
    p.add_argument("--no_pallas", action="store_true",
                   help="run the cdf kernels' plain PyTorch versions (a CPU "
                        "reference: refused on a GPU)")
    p.add_argument("--no_fast_codec", action="store_true",
                   help="run the stage codec on F.conv2d instead of the "
                        "codec kernels (a CPU reference: refused on a GPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    p.add_argument("--cache_dir", type=str, default="",
                   help="where the CUDA kernels build to ('' = "
                        "build/torch_kernels/ in the repository)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--quiet", dest="verbose", action="store_false")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import api
    from .ops import cuda_build

    cuda_build.set_build_dir(args.cache_dir)
    cfg = api.config_from_args(args)
    cfg.compat_schedule_quirk = not args.no_schedule_quirk
    cfg.use_pallas = not args.no_pallas
    cfg.cov_propagation = not args.no_cov_prop
    cfg.fast_codec = not args.no_fast_codec
    profiler = contextlib.nullcontext()
    if args.profile_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
    run = api.run_style_parallel if args.style_parallel else api.run_files
    with profiler as prof:
        _, seconds, paths = run(cfg, verbose=args.verbose, device=args.device)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print("profile", trace)
    print("Took:", seconds)
    for path in paths:
        print("saved", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
