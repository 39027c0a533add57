"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W) and
the least time each kernel of the port could take: operations and bytes
counted once from the shapes the schedule gives, whatever kernel does the
work.

A kernel's bound is max(operations / peak rate, bytes / 3.35 TB/s): every
input byte read once, every output byte written once. Operations are 2 x
MACs of the convolution the layer computes; an upconv (nearest x2, then a
3x3 conv) needs 4 taps an output pixel, since each output phase sees a
2 x 2 window of the coarse input."""

from __future__ import annotations

from . import flops, schedule

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}   # bf16; TF32 rate
PEAK_BYTES = 3.35e12

# kernel-name substrings of the codec kernels, per conv dtype
CODEC_KERNELS = {
    "bfloat16": ("conv3x3_wg", "upconv_wg", "final_to_rgb_mma",
                 "rgb_to_relu1_mma"),
    "float32": ("conv3x3_tf32x3", "upconv_tf32x3", "final_to_rgb_tma",
                "rgb_to_relu1_tma"),
}
CDF_KERNELS = ("histogram_cluster", "pwl_tables")


def _conv(n_out_px: float, taps: int, cin: int, cout: int,
          in_bytes: float, out_bytes: float) -> tuple:
    """(flops, bytes) of one launch: ``n_out_px`` output pixels."""
    flops = 2.0 * n_out_px * taps * cin * cout
    return flops, in_bytes + out_bytes + taps * cin * cout * 4 + cout * 4


def codec_launches(batch: int, h: int, w: int, depth: int, act: int):
    """[(flops, bytes)] of the codec kernels of one stage at relu{depth}_1
    on pixels (batch, h, w): the encoder head and the decoder tail of
    ``models/fastcodec``. ``act``: bytes of a feature element (2 bf16, 4
    float32); the RGB in and out is float32."""
    b = float(batch)
    p1, p2, p4 = b * h * w, b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    out = [_conv(p1, 9, 3, 64, p1 * 3 * 4, p1 * 64 * act)]      # rgb_to_relu1
    if depth >= 2:
        out.append(_conv(p1, 9, 64, 64, p1 * 64 * act, p2 * 64 * act))
        out.append(_conv(p2, 9, 64, 128, p2 * 64 * act, p2 * 128 * act))
    if depth >= 3:
        out.append(_conv(p2, 9, 128, 128, p2 * 128 * act, p4 * 128 * act))
        out.append(_conv(p2, 4, 128, 128, p4 * 128 * act, p2 * 128 * act))
    if depth >= 2:
        out.append(_conv(p2, 9, 128, 64, p2 * 128 * act, p2 * 64 * act))
        out.append(_conv(p1, 4, 64, 64, p2 * 64 * act, p1 * 64 * act))
    out.append(_conv(p1, 9, 64, 3, p1 * 64 * act, p1 * 3 * 4))  # final_to_rgb
    return out


def cdf_launches(n: int, n_style: int, k: int, n_iters: int):
    """[(flops, bytes)] of one stage's cdf steps, two launches a step: the
    histograms of both rotated clouds (k x n and k x n_style float32 read,
    2 x k x 256 counts written) and the remap (k x n read, its k x 256
    table read, k x n written). No operation counts: both are bytes."""
    hist = 4.0 * (k * n + k * n_style + 2 * k + 2 * k * 256)
    remap = 4.0 * (2 * k * n + k * 256 + 2 * k)
    return [(0.0, hist), (0.0, remap)] * n_iters


def bound_s(launches, peak_flops: float) -> float:
    return sum(max(f / peak_flops, by / PEAK_BYTES) for f, by in launches)


def call_launches(plan, batch: int, depth: int, act: int, rows: int = 1,
                  style_hw=None, ks=None, kind: str = "codec"):
    """The launches of one call: ``plan`` from ``schedule.pass_plan``,
    ``rows`` the ranks a pass's rows are split over (each rank's own rows
    are counted). ``kind`` "cdf" needs the style's (h, w) and ``ks``."""
    out = []
    for p, (s, _, iters) in enumerate(plan):
        h, w = s // rows, s
        for l in range(depth):
            d = depth - l
            if kind == "codec":
                out += codec_launches(batch, h, w, d, act)
            else:
                fh, fw = flops.feat_hw(h, w, d)
                sh, sw = (schedule.get_size(s, *style_hw) if plan[p][1]
                          else style_hw)
                sfh, sfw = flops.feat_hw(sh, sw, d)
                out += cdf_launches(batch * fh * fw, sfh * sfw, ks[p][l],
                                    iters[l])
    return out
