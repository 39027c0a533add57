"""The cdf step's kernels on the GPU: ``batched_histogram`` (both clouds of
a step), ``pwl_remap`` and the legacy fused ``cdf_remap``, each against its
plain version at the cdf step's shapes, with their times side by side.

    python3 optimaltextures_tpu_torch/tools/cdf_kernels.py [--root TREE]
        [--seed N] [--reps R] [--path]

The clouds are made as a cdf step makes them, with the real depth-3 weights,
a style exemplar and a noise pastiche made from ``--seed``: features
projected on the style's first k principal components (the PCA 90% rule)
and rotated, the pastiche's as the target, the style's samples as the
source:

* ``relu1``: the 512-px pass, C = k1, N = 512^2;
* ``pixels``: the color tail's 512 x 512 pixels, C = 3 (the lum target
  built from a content exemplar as the source);
* ``relu3``: the 256-px pass, C = k3 there, N = 64^2.

``--root`` imports the port's package from another checkout of the repo (an
older tree unpacked with ``git archive``), so two versions are timed by the
same script in one call. A tree without ``cdf.histogram_pair`` counts a cdf
step's histograms with two ``batched_histogram`` calls, as its cdf step did.

For each kernel and cloud it prints:

* ``device``: the device time of every kernel ``torch.profiler`` saw over
  R back-to-back wrapper calls, over R, and which kernels those were
  (launches a call): the wrappers' own fills and elementwise kernels show
  here beside the cdf kernel;
* ``events``: CUDA events around the same loop, over R (for a kernel of
  tens of microseconds this reads the host, not the kernel);
* ``host``: the wrapper's host time per call;
* the bytes bound (each input read once, each output written once, over the
  card's memory rate) and the operations bound (f32 operations a sample
  over the FP32 rate).

The repeated calls find their inputs in the 50 MB L2 where they fit (the
pixel and relu3 clouds; on the path the rotation GEMM has just written
them). Then it prints the k of every depth at every pass size and the bytes
that path A's cdf kernels must move in one run (16 bytes a sample a step:
both clouds read by the histogram, the target read and written by the
remap), with that bound's time.

``--path`` then profiles one warm 512-px path-A run (cdf synthesis, the
style exemplar of ``chip_smoke.py``) and prints the device time and
launches of the cdf kernels over the run, beside the run's fill and
elementwise launches and all its launches: the launches the cdf wrappers
made besides their kernels show as the difference between two trees.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

# f32 operations a sample, for the operations bound: the histogram's bin
# (subtract, multiply, divide), the remap's segment and lerp, cdf_remap's
# guessed segment, its check and the lerp
OPS_PER_SAMPLE = {"batched_histogram": 3.0, "pwl_remap": 12.0, "cdf_remap": 14.0}


def device_breakdown(fn, reps: int) -> dict:
    """{kernel name: (device ms a call, launches a call)} for every kernel
    torch.profiler records over ``reps`` calls of ``fn``: a kernel's mean
    time over the launches recorded, times its launches a call rounded to
    a whole number (the profiler can drop a few events of a long loop).
    If the profiler records no device time, one row of the CUDA events'
    time a call, named so."""
    from optimaltextures_tpu_torch.tools import edge_convs

    rows = edge_convs.profiled_kernels(fn, reps)
    if rows is None:
        return {"all kernels (CUDA events)": (edge_convs.event_ms(fn, reps), 1)}
    out = {}
    for key, us, count in rows:
        per_call = max(1, round(count / reps))
        out[key] = (us / 1e3 / count * per_call, per_call)
    return out


def _prep(synth, style, size: int):
    """One pass's style prep at ``size``: (ks per depth, deepest first;
    [(eigvecs, stats, mean)] per depth)."""
    spectra = synth._dispatch_style_prep([style], size, True)
    svals = [sv.cpu().numpy() for (_, sv, _) in spectra]
    ks, masks = synth._choose_widths(spectra, svals)
    return ks, synth._finish_style_prep(spectra, ks, masks)


def clouds(seed: int):
    """The three clouds [(label, target rows, source rows)], the ks of every
    pass size {size: ks, deepest first}, and the Synthesizer."""
    import torch
    import torch.nn.functional as F

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.models.vgg import encode
    from optimaltextures_tpu_torch.ops import colors
    from optimaltextures_tpu_torch.ops.rotation import (generator,
                                                        random_rotation,
                                                        stage_rotations)

    from optimaltextures_tpu_torch.tools import edge_convs as ec

    dev = torch.device("cuda")
    synth = core.Synthesizer(OptexConfig(size=512, seed=seed, hist_mode="cdf",
                                         style=["smoke_style"]), device=dev)
    style = torch.as_tensor(ec.style_exemplar(seed + 1), device=dev)
    ks, preps = {}, {}
    for size in sorted(set(int(s) for s in synth.sizes)):
        ks[size], preps[size] = _prep(synth, style, size)
    gen = generator(dev, seed, 77)
    noise = torch.rand((1, 512, 512, 3), generator=gen, device=dev)
    out = []
    # (label, pass size, depth): depth d sits at index 3 - d (deepest first)
    for label, size, depth in (("relu1", 512, 1), ("relu3", 256, 3)):
        eigvecs, stats, _ = preps[size][3 - depth]
        k = int(ks[size][3 - depth])
        img = noise if size == 512 else F.interpolate(
            noise.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).contiguous()
        feat = encode(synth.bank.enc_params[depth], depth, img) @ eigvecs
        rot = stage_rotations(gen, 1, k, dev)[0]
        n = feat.shape[1] * feat.shape[2]
        out.append((f"{label} C={k}, N={feat.shape[1]}^2",
                    (rot.T @ feat.reshape(-1, k).T).contiguous(),
                    (rot.T @ stats.samples.T).contiguous()))
        assert out[-1][1].shape == (k, n)
    content = torch.as_tensor(ec.style_exemplar(seed + 3), device=dev)
    target = colors.swap_lightness(content, noise)
    rot3 = random_rotation(gen, 3, dev)
    out.insert(1, ("pixels C=3, N=512^2",
                   (rot3.T @ noise.reshape(-1, 3).T).contiguous(),
                   (rot3.T @ target.reshape(-1, 3).T).contiguous()))
    return out, ks, synth


def run_bytes(synth, ks) -> float:
    """Bytes path A's cdf kernels must move in one run: per cdf step 16
    bytes for every sample of the k-channel clouds (target and source of
    N = (S / 2^(d-1))^2 samples at depth d of a pass of size S each read by
    the histogram, the target read and written by the remap)."""
    total = 0.0
    for size, iters in zip(synth.sizes, synth.iters_table):
        for pos, steps in enumerate(iters):          # deepest first
            depth = len(iters) - pos
            n = (int(size) // 2 ** (depth - 1)) ** 2
            total += steps * 16.0 * int(ks[int(size)][pos]) * n
    return total


def _histc(x, lo_f, hi_f):
    import torch

    return torch.stack([torch.histc(x[i], 256, lo_f[i], hi_f[i])
                        for i in range(x.shape[0])])


def time_cdf_kernels(seed: int, reps: int, card: str):
    """Check the three kernels against their plain versions on each cloud
    (the histograms equal and equal to torch.histc, the remap torch.equal,
    cdf_remap within 1e-5 x max|plain|, so that an older tree's kernel
    timed with ``--root`` passes too; its row's ``equal`` says whether it is
    bit-equal) and time them. Returns ({(kernel,
    label): dict(err, device_ms, kernels, ms, host_us, plain_ms, lib_ms,
    t_flops, t_bytes)}, ks, run bytes)."""
    import torch

    from optimaltextures_tpu_torch.ops import cdf, histmatch
    from optimaltextures_tpu_torch.tools import edge_convs as ec

    peak_flops, peak_bw = ec.peaks(card)
    cl, ks, synth = clouds(seed)
    pair = getattr(cdf, "histogram_pair", None)
    rows = {}

    def report(kernel, label, r):
        rows[(kernel, label)] = r
        bound = max(r["t_bytes"], r["t_flops"])
        kern = ", ".join(f"{k[:40]} {ms * 1e3:.2f} us x{n}"
                         for k, (ms, n) in sorted(r["kernels"].items()))
        lib = "none" if r["lib_ms"] is None else f"{r['lib_ms']:.4f} ms"
        print(f"cdf {kernel:17s} {label:20s} err {r['err']:.2e}  device "
              f"{r['device_ms'] * 1e3:.2f} us ({100 * bound / r['device_ms']:.0f}% "
              f"of the bound)  events {r['ms'] * 1e3:.2f} us  host "
              f"{r['host_us']:.1f} us/call  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  bound bytes {r['t_bytes'] * 1e3:.2f} us, "
              f"operations {r['t_flops'] * 1e3:.2f} us  [{kern}]", flush=True)

    def timed(kernel, fn, plain, lib, err, samples, nbytes):
        kernels = device_breakdown(fn, reps)
        return dict(err=err, kernels=kernels,
                    device_ms=sum(ms for ms, _ in kernels.values()),
                    ms=ec.event_ms(fn, reps), host_us=ec.host_us(fn, reps),
                    plain_ms=ec.event_ms(plain, reps),
                    lib_ms=None if lib is None else ec.event_ms(lib, reps),
                    t_bytes=nbytes / peak_bw * 1e3,
                    t_flops=OPS_PER_SAMPLE[kernel] * samples / peak_flops * 1e3)

    for label, t, s in cl:
        c, nt = t.shape
        ns = s.shape[1]
        lo = torch.minimum(t.min(dim=1).values, s.min(dim=1).values)
        hi = torch.maximum(t.max(dim=1).values, s.max(dim=1).values)
        lo_f, hi_f = lo.tolist(), hi.tolist()
        keep = [i for i in range(c) if hi_f[i] > lo_f[i]]

        # batched_histogram: both clouds of the step
        if pair is not None:
            hist = lambda: pair(t, s, lo, hi)
        else:
            hist = lambda: (cdf.batched_histogram(t, lo, hi),
                            cdf.batched_histogram(s, lo, hi))
        plain = lambda: (cdf.histogram_plain(t, lo, hi),
                         cdf.histogram_plain(s, lo, hi))
        got, ref = hist(), plain()
        for side, g, r, x in zip(("target", "source"), got, ref, (t, s)):
            if not torch.equal(g, r):
                raise AssertionError(f"batched_histogram [{label}, {side}] "
                                     "differs from its plain version")
            if not torch.equal(g[keep], _histc(x, lo_f, hi_f)[keep]):
                raise AssertionError(f"batched_histogram [{label}, {side}] "
                                     "differs from torch.histc")
        report("batched_histogram", label, timed(
            "batched_histogram", hist, plain,
            lambda: (_histc(t, lo_f, hi_f), _histc(s, lo_f, hi_f)), 0.0,
            c * (nt + ns), 4.0 * (c * (nt + ns) + 2 * c + 2 * c * 256)))
        t_hist, s_hist = ref

        # pwl_remap on the remap tables of this cloud's histograms
        t_cdf, s_cdf = histmatch.cdf_cdfs_rows(t_hist, s_hist)
        remapped = histmatch._remap_table_rows(
            t_cdf, s_cdf, histmatch._edges_rows(lo, hi, 256))
        got = cdf.pwl_remap(t, remapped, lo, hi)
        ref = cdf.pwl_remap_plain(t, remapped, lo, hi)
        if not (torch.isfinite(got).all() and torch.equal(got, ref)):
            raise AssertionError(f"pwl_remap [{label}]: not equal to its plain "
                                 f"version (max diff "
                                 f"{float((got - ref).abs().max()):.3e})")
        report("pwl_remap", label, timed(
            "pwl_remap", lambda: cdf.pwl_remap(t, remapped, lo, hi),
            lambda: cdf.pwl_remap_plain(t, remapped, lo, hi), None, 0.0, c * nt,
            4.0 * (2 * c * nt + c * 256 + 2 * c)))

        # cdf_remap, the legacy fused apply, on the kernel's histograms
        got = cdf.cdf_remap(t, t_hist, s_hist, lo, hi)
        ref = cdf.cdf_remap_plain(t, t_hist, s_hist, lo, hi)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= 1e-5 * scale):
            raise AssertionError(f"cdf_remap [{label}]: max|kernel - plain| = "
                                 f"{err:.3e} over max|plain| = {scale:.3e}")
        report("cdf_remap", label, dict(timed(
            "cdf_remap", lambda: cdf.cdf_remap(t, t_hist, s_hist, lo, hi),
            lambda: cdf.cdf_remap_plain(t, t_hist, s_hist, lo, hi), None, err,
            c * nt, 4.0 * (2 * c * nt + 2 * c * 256 + 2 * c)),
            equal=torch.equal(got, ref)))
        torch.cuda.synchronize()

    for size in sorted(ks):
        print(f"k at the {size}-px pass (relu3, relu2, relu1): "
              f"{tuple(int(k) for k in ks[size])}", flush=True)
    k512 = [int(k) for k in ks[512]]
    print(f"k1 = {k512[2]}, k2 = {k512[1]}, k3 = {k512[0]} (512-px pass); "
          f"k3 = {int(ks[256][0])} at the 256-px pass", flush=True)
    nbytes = run_bytes(synth, ks)
    print(f"path A: the cdf kernels move {nbytes / 1e9:.4f} GB a run, "
          f"{nbytes / peak_bw * 1e3:.4f} ms at the memory rate", flush=True)
    return rows, ks, nbytes


CDF_KERNEL = re.compile(r"histogram_(kernel|cluster)|pwl_(kernel|tables)")


def path_a_profile(seed: int) -> dict:
    """One warm 512-px path-A run under torch.profiler (after a cold one):
    {name: (device ms, launches)} of its cdf kernels, with "fill",
    "elementwise" and "all" (launch counts; "all" also the busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.config import OptexConfig
    from optimaltextures_tpu_torch.tools import edge_convs

    cfg = OptexConfig(size=512, seed=seed, hist_mode="cdf", style=["smoke_style"])
    style = edge_convs.style_exemplar(seed + 1)
    core.synthesize(cfg, [style], None, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = core.synthesize(cfg, [style], None, device="cuda")
        torch.cuda.synchronize()
    out = {"fill": (0.0, 0), "elementwise": (0.0, 0), "all": (0.0, 0)}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        keys = ["all"]
        if CDF_KERNEL.search(e.key):
            keys.append(CDF_KERNEL.search(e.key).group(0))
        if "Fill" in e.key or "Memset" in e.key:
            keys.append("fill")
        if "elementwise" in e.key:
            keys.append("elementwise")
        for k in keys:
            t, n = out.get(k, (0.0, 0))
            out[k] = (t + ms, n + e.count)
    cdf_ms = sum(t for k, (t, _) in out.items() if CDF_KERNEL.fullmatch(k))
    print(f"path A (warm, profiled): wall {wall * 1e3:.1f} ms, device busy "
          f"{out['all'][0]:.3f} ms over {out['all'][1]} launches; cdf kernels "
          f"{cdf_ms:.4f} ms a run ("
          + ", ".join(f"{k} {t:.4f} ms x{n}" for k, (t, n) in sorted(out.items())
                      if CDF_KERNEL.fullmatch(k))
          + f"); fill kernels x{out['fill'][1]}, elementwise kernels "
          f"x{out['elementwise'][1]}", flush=True)
    _per_stage(prof, cfg)
    return out


def _per_stage(prof, cfg) -> None:
    """A cdf step launches the remap once and the histogram once (a tree
    before histogram_pair: twice), in schedule order: pass by pass, deepest
    depth first. Print the kernels' device times in launch order, summed by
    (pass size, depth)."""
    import torch

    from optimaltextures_tpu_torch.utils import schedule

    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and CDF_KERNEL.search(e.name):
            kind = "hist" if "histogram" in e.name else "remap"
            per.setdefault(kind, []).append((e.time_range.start,
                                             e.time_range.elapsed_us()))
    table, sizes = schedule.iters_and_sizes(cfg.size, cfg.iters, cfg.passes,
                                            not cfg.no_multires, num_layers=3)
    steps = [(int(size), len(iters) - pos, int(n))
             for size, iters in zip(sizes, table) for pos, n in enumerate(iters)]
    total = sum(n for _, _, n in steps)
    hist = [us for _, us in sorted(per.get("hist", []))]
    remap = [us for _, us in sorted(per.get("remap", []))]
    if len(remap) != total or len(hist) % total:
        print(f"path A per stage: {len(hist)} histogram and {len(remap)} remap "
              f"launches for {total} steps; not grouped", flush=True)
        return
    per_step = len(hist) // total
    i = 0
    for size, depth, n in steps:
        h = sum(hist[i * per_step:(i + n) * per_step])
        r = sum(remap[i:i + n])
        i += n
        print(f"  pass {size} px relu{depth}: {n} steps, histogram "
              f"{h:.1f} us ({h / n:.2f} a step), remap {r:.1f} us "
              f"({r / n:.2f} a step)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose optimaltextures_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--path", action="store_true",
                    help="also profile one warm 512-px path-A run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("cdf_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    from optimaltextures_tpu_torch import core
    from optimaltextures_tpu_torch.ops import cdf

    core.full_f32_precision()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"cdf_kernels: {os.path.abspath(cdf.__file__)} on {card}", flush=True)
    cdf.build()
    time_cdf_kernels(args.seed, args.reps, card)
    if args.path:
        path_a_profile(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
