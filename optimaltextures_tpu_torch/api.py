"""High-level library API (the counterpart of ``optimaltextures_tpu/api.py``):
texture synthesis, style transfer, texture mixing and color transfer from
files in one call each, and style-parallel synthesis (one texture per
style).

A run with ``num_devices = N`` and ``spatial_devices = S``, N * S > 1, runs
on N * S ranks, one process per device: inside a ``torch.distributed``
process group (torchrun) on that group, else on N * S processes that the
call starts (``parallel.mesh.spawn``): NCCL on ``cuda:0 .. cuda:N*S-1``, or
gloo with ``device="cpu"``. Rank 0 writes the files and its result is
returned."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np

from . import core
from .config import OptexConfig
from .utils import imageio

# the kernel libraries of a run, built before ranks are started so that the
# ranks only load them
_RUN_LIBRARIES = ("codec", "cdf", "conv_wg", "edge_mma")


def _on_ranks(n: int, device, target, args):
    """``target(mesh, *args)`` on n ranks: this process's rank of the current
    process group, or n new processes (NCCL on the GPUs, gloo on the CPU),
    whose rank 0's result is returned."""
    import torch
    import torch.distributed as dist

    from .parallel import mesh as mesh_mod

    if dist.is_available() and dist.is_initialized():
        return target(mesh_mod.make_mesh(n, device=device), *args)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return mesh_mod.spawn(target, n, backend="gloo", device="cpu",
                              args=args)
    if torch.cuda.device_count() < n:
        raise ValueError(f"{n} devices (num_devices x spatial_devices) need "
                         f"{n} GPUs, this machine has "
                         f"{torch.cuda.device_count()}")
    from .ops import cuda_build

    cuda_build.build(*_RUN_LIBRARIES)
    return mesh_mod.spawn(target, n, backend="nccl", device="cuda",
                          args=args)


def _run_files_rank(mesh, cfg, verbose):
    return _run_files_here(cfg, verbose and mesh.rank == 0, mesh.device,
                           mesh, save=mesh.rank == 0)


def _run_files_here(cfg, verbose, device, mesh=None, save=True):
    styles = imageio.load_styles(cfg.style, cfg.size, cfg.style_scale)
    content = imageio.maybe_load_content(cfg.content, cfg.size)
    pastiche = None
    if cfg.init is not None:
        pastiche = imageio.load_image(cfg.init, cfg.size, oversize=False)
        if content is not None and pastiche.shape != content.shape:
            raise ValueError(
                f"--init image loads to {tuple(pastiche.shape)} but the "
                f"content loads to {tuple(content.shape)}; they must match")
    out, seconds = core.synthesize(cfg, styles, content, pastiche=pastiche,
                                   verbose=verbose, device=device, mesh=mesh)
    out_np = out.cpu().numpy()
    return out_np, seconds, imageio.save_images(out_np, cfg) if save else []


def run_files(cfg: OptexConfig, verbose: bool = False, device=None
              ) -> Tuple[np.ndarray, float, List[str]]:
    """Load the style (and content, and init) images per cfg, run, save
    PNG(s). Returns (output array NHWC, seconds, written paths). ``device``
    None = the GPU(s).

    ``cfg.init``: the starting pastiche in place of noise, loaded at
    ``size`` like a content image (``oversize=False``); with a content
    image both must load to the same shape. ``cfg.num_devices > 1`` (batch
    data parallelism) and/or ``cfg.spatial_devices > 1`` (spatial sharding;
    both: the 2-D grid): a run on num_devices x spatial_devices ranks
    (module docstring)."""
    cfg.validate()
    if cfg.init is not None and cfg.batch > 1:
        # every batch element would start identical AND share the run's
        # rotation stream -> N identical outputs for N x the device work
        raise ValueError("batch > 1 with --init produces identical images; "
                         "run batch=1")
    n = cfg.num_devices * cfg.spatial_devices
    if n > 1:
        if cfg.batch % cfg.num_devices:
            raise ValueError(f"batch {cfg.batch} not divisible by "
                             f"num_devices {cfg.num_devices}")
        return _on_ranks(n, device, _run_files_rank, (cfg, verbose))
    return _run_files_here(cfg, verbose, device)


def _style_parallel_rank(mesh, cfg, styles, verbose):
    from .parallel.style_dp import synthesize_style_batch

    t0 = time.time()
    out = synthesize_style_batch(cfg, styles, mesh,
                                 verbose=verbose and mesh.rank == 0)
    out_np = out.cpu().numpy()
    return out_np, time.time() - t0


def run_style_parallel(cfg: OptexConfig, verbose: bool = False, device=None
                       ) -> Tuple[np.ndarray, float, List[str]]:
    """Style-parallel synthesis: ONE output texture per style image, one
    style per device when num_devices > 1 (on that many ranks, as
    :func:`run_files`), every style on one device otherwise. PCA and the
    multires schedule apply. Returns (outputs (N, H, W, 3), seconds,
    written paths: one PNG per style, named per style)."""
    # the JAX package's refusals, before validate(): the grid validation's
    # batch-divisibility message would pre-empt these clearer errors
    if cfg.content is not None:
        raise ValueError("style_parallel is synthesis-only (no content)")
    unsupported = [name for name, bad in [
        ("tileable", cfg.tileable), ("init", cfg.init is not None),
        ("out_width", cfg.out_width is not None), ("batch", cfg.batch != 1),
        ("color_transfer", cfg.color_transfer is not None),
        ("spatial_devices", cfg.spatial_devices > 1)] if bad]
    if unsupported:
        raise ValueError("style_parallel does not support: "
                         + ", ".join(unsupported))
    cfg = cfg.validate()
    styles = imageio.load_styles(cfg.style, cfg.size, cfg.style_scale)
    if any(s.shape != styles[0].shape for s in styles[1:]):
        raise ValueError("style_parallel needs equal style shapes")
    if cfg.num_devices > 1:
        if len(styles) != cfg.num_devices:
            raise ValueError(f"{len(styles)} styles for num_devices="
                             f"{cfg.num_devices}: pass one style per device")
        out_np, seconds = _on_ranks(cfg.num_devices, device,
                                    _style_parallel_rank,
                                    (cfg, styles, verbose))
    else:
        from .parallel.style_dp import synthesize_style_batch

        t0 = time.time()
        out_np = synthesize_style_batch(cfg, styles, None, verbose=verbose,
                                        device=device).cpu().numpy()
        seconds = time.time() - t0
    paths: List[str] = []
    for i, sp in enumerate(cfg.style):
        paths += imageio.save_images(out_np[i:i + 1],
                                     dataclasses.replace(cfg, style=[sp]))
    return out_np, seconds, paths


def synthesize_texture(style: str, size: int = 512, device=None,
                       **overrides) -> np.ndarray:
    """Texture synthesis from noise matched to one style exemplar."""
    out, _, _ = run_files(OptexConfig(style=[style], size=size, **overrides),
                          device=device)
    return out


def transfer_style(style: str, content: str, size: int = 512,
                   content_strength: float = 0.2, device=None,
                   **overrides) -> np.ndarray:
    """Style transfer: synthesis pulled toward a content image's structure."""
    out, _, _ = run_files(OptexConfig(style=[style], content=content, size=size,
                                      content_strength=content_strength,
                                      **overrides), device=device)
    return out


def mix_textures(style_a: str, style_b: str, *more_styles: str,
                 alpha: float = 0.5, weights=None, size: int = 512,
                 device=None, **overrides) -> np.ndarray:
    """Texture mixing with a random spatial mask: two styles blend by
    ``alpha`` (the reference's blend), three or more by ``weights`` (one
    positive weight per style, default uniform). ``alpha`` is keyword-only,
    so a float passed by position is refused instead of read as a path."""
    for s in (style_a, style_b, *more_styles):
        if not isinstance(s, str):
            raise TypeError(
                f"style paths must be strings, got {s!r} — if this was "
                "alpha, pass it by keyword: mix_textures(a, b, alpha=...)")
    out, _, _ = run_files(OptexConfig(style=[style_a, style_b, *more_styles],
                                      mixing_alpha=alpha,
                                      mixing_weights=weights, size=size,
                                      **overrides), device=device)
    return out


def transfer_color(style: str, content: str, mode: str = "opt",
                   size: int = 512, device=None, **overrides) -> np.ndarray:
    """Style transfer that keeps the content image's colors (lum | opt)."""
    out, _, _ = run_files(OptexConfig(style=[style], content=content,
                                      color_transfer=mode, size=size,
                                      **overrides), device=device)
    return out


def _style_batch_rank(mesh, cfg, imgs):
    from .parallel.style_dp import synthesize_style_batch

    return synthesize_style_batch(cfg, imgs, mesh).cpu().numpy()


def synthesize_style_batch(styles: List[str], size: int = 512,
                           num_devices: int = 0, device=None,
                           **overrides) -> np.ndarray:
    """Style-parallel synthesis: one texture per style, one style per device
    (collective-free: the transpose of ``--batch``'s joint statistics).
    Styles must load to one shape. ``num_devices`` defaults to len(styles);
    1 runs the same per-style math on one device. Returns (N, H, W, 3)."""
    from .parallel.style_dp import synthesize_style_batch as _batch

    cfg = OptexConfig(style=list(styles), size=size, **overrides)
    imgs = [imageio.load_image(s, size, oversize=False) for s in styles]
    n = num_devices or len(styles)
    if n > 1:
        return _on_ranks(n, device, _style_batch_rank, (cfg, imgs))
    return _batch(cfg, imgs, None, device=device).cpu().numpy()


def config_from_args(args) -> OptexConfig:
    """Build a config from an argparse Namespace with matching field names."""
    fields = {f.name for f in dataclasses.fields(OptexConfig)}
    return OptexConfig(**{k: v for k, v in vars(args).items() if k in fields})
