"""The codec conv kernels: the port of ``optimaltextures_tpu/ops/pallas/codec.py``.

The five Pallas kernels there compute one operation — a 3x3 reflect-padded
conv with bias, differing in channel counts, an optional nearest-x2 prologue
and an optional ReLU / 2x2 max-pool epilogue — in a TPU layout (batch in the
128 lanes, 2-pixel M-packing, 8-channel padded RGB, DMA-then-repair halos).
None of that layout carries over: here every kernel takes and returns NHWC
float32 at any batch. Four run on one FFMA template (``csrc/codec.cu``,
``conv3x3_reflect<CIN, COUT, ..., RELU, POOL, UP>``); ``conv3x3_full`` runs
on the tensor cores (``conv3x3_tf32x3<CIN, RELU, POOL>``, 3xTF32 on
``mma.sync``).

Each wrapper below:

* on a CPU tensor runs its plain PyTorch version (:func:`conv3x3_plain`
  with the wrapper's flags; the CPU tests hold it against the JAX kernels
  in interpret mode);
* on a CUDA tensor launches its kernel on the current stream, or raises —
  nothing falls back;
* counts its launches in ``LAUNCHES[name]`` (plain versions do not count).

Each conv's weights are packed once (:func:`pack`, :func:`pack_final`, as
the JAX package's ``pack_*``): OIHW for the plain version, an HWIO copy for
the FFMA kernels, whose [tap][ci][co] rows load into shared memory
contiguously, and for the 128-channel convs the TF32 hi/lo split in the
tensor-core kernel's fragment order (:func:`pack_tc`).

What bounds them on the H100 (67 TFLOP/s FFMA, 495 TFLOP/s dense TF32 on
the tensor cores and 3.35 TB/s HBM on the SXM part): the 64/128-channel
convs do 2*9*Cin FLOPs per output value against 4 bytes read and 4 written
per value, ~290-580 FLOP/B, far above the card's ridge, so they are
operations-bound; the 3->64 entry and 64->3 final convs do 54 / 1152 FLOPs
per 4+256 / 256+12 bytes of pixel traffic, so they are bytes-bound. The
design answers each: the wide FFMA convs keep a 4-pixel x 16-channel f32
accumulator tile per thread fed from shared memory (weights broadcast
across a warp), and ``conv3x3_full`` moves its products to the tensor cores
at three TF32 products per f32 product (one TF32 product misses the 2e-5
bound); the narrow ones read their input once and write their output once,
with the reflect pad resolved while loading and the next stage's renorm
folded into the final conv's weights, so no padded, upsampled or
renormalised copy ever reaches device memory.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .convops import to_nchw, to_nhwc

LAUNCHES = {"rgb_to_relu1": 0, "conv3x3_p2": 0, "conv3x3_full": 0,
            "upconv_p2": 0, "final_to_rgb": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Packed(NamedTuple):
    """One conv's weights: ``w`` (Cout, Cin, 3, 3) OIHW and ``b`` (Cout,) for
    the plain version, ``w_hwio`` (3, 3, Cin, Cout) for the FFMA kernels, and
    for a 64|128 -> 128 conv ``w_tc``, the TF32 hi/lo split in the tensor-core
    kernel's fragment order (:func:`pack_tc`; None for other shapes)."""
    w: torch.Tensor
    b: torch.Tensor
    w_hwio: torch.Tensor
    w_tc: Optional[torch.Tensor] = None


def pack(w: torch.Tensor, b: torch.Tensor) -> Packed:
    w_hwio = w.permute(2, 3, 1, 0).contiguous()
    tc = w.shape[0] == 128 and w.shape[1] in (64, 128)
    return Packed(w, b, w_hwio, pack_tc(w_hwio) if tc else None)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 x -> (hi, lo), both TF32 values (the low 13 of the 23
    mantissa bits zero) with hi + lo = x to ~2^-22 relative: hi is x rounded
    to TF32 to nearest, ties away from zero (PTX ``cvt.rna.tf32.f32``), lo
    the remainder x - hi (exact in f32) rounded the same way."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x.to(torch.float32))
    return hi, rna(x - hi)


def pack_tc(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, 128) HWIO -> (Cin/8, 9, 16, 32, 4) float32, the weights of
    ``conv3x3_full``'s tensor-core kernel: per input-channel chunk c of 8
    (one k8 step), tap, n8 tile j and lane (g = lane // 4, t = lane % 4) the
    lane's B fragments {hi(k), hi(k + 4), lo(k), lo(k + 4)} of
    ``w[tap, 8c + k, 8j + g]`` at k = t (:func:`split_tf32`), so one chunk is
    one contiguous block and a lane's fragment one 16-byte load."""
    _, _, cin, cout = w_hwio.shape
    hi, lo = split_tf32(w_hwio.reshape(9, cin // 8, 2, 4, cout // 8, 8))
    # (tap, c, k-half, t, j, g) -> (c, tap, j, g, t, [hi0, hi1, lo0, lo1])
    frag = torch.stack([hi[:, :, 0], hi[:, :, 1], lo[:, :, 0], lo[:, :, 1]], -1)
    return frag.permute(1, 0, 3, 4, 2, 5).reshape(
        cin // 8, 9, cout // 8, 32, 4).contiguous()


def pack_final(w_fin: torch.Tensor, b_fin: torch.Tensor,
               renorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Packed:
    """The decoder-final conv (w_fin (3, 64, 3, 3), b_fin (3,)) with the next
    stage's encoder 1x1 RGB renorm (w (3, 3, 1, 1), b (3,)) folded in: both
    are linear with nothing between them in a stage roundtrip (the math of
    the JAX package's ``pack_final_rgb``). ``None`` (the pass's last decode)
    leaves the final conv as it is."""
    if renorm is not None:
        rn = renorm[0][:, :, 0, 0]                     # (out, in)
        w_fin, b_fin = (torch.einsum("ok,kirc->oirc", rn, w_fin),
                        renorm[1] + rn @ b_fin)
    return pack(w_fin, b_fin)


# ---------------------------------------------------------------------------
# the library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "optex_rgb_to_relu1": [_P, _P, _P, _P, _I, _I, _I, _P],
    "optex_conv3x3_p2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "optex_conv3x3_full": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "optex_upconv_p2": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "optex_final_to_rgb": [_P, _P, _P, _P, _I, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("codec")
    if not getattr(lib, "_optex_typed", False):
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.optex_error_string.argtypes = [_I]
        lib.optex_error_string.restype = ctypes.c_char_p
        lib._optex_typed = True
    return lib


def build() -> None:
    """Build and load the kernels now (they otherwise build at first use)."""
    _lib()


def conv3x3_plain(x: torch.Tensor, p: Packed, relu: bool = False,
                  pool: bool = False, up: bool = False) -> torch.Tensor:
    """The plain PyTorch version of every kernel here: NHWC x ->
    [2x2 ceil max-pool] [relu] conv3x3_reflect([nearest_up_x2] x), NHWC."""
    t = to_nchw(x)
    if up:
        t = F.interpolate(t, scale_factor=2, mode="nearest")
    t = F.conv2d(F.pad(t, (1, 1, 1, 1), mode="reflect"), p.w, p.b)
    if relu:
        t = torch.relu(t)
    if pool:
        t = F.max_pool2d(t, 2, 2, ceil_mode=True)
    return to_nhwc(t)


def _conv(name: str, x: torch.Tensor, p: Packed, cins, cout: int,
          relu: bool = False, pool: bool = False, up: bool = False,
          args=()) -> torch.Tensor:
    """Validate the operands, then run the plain version on a CPU tensor or
    launch the kernel ``optex_<name>(x, w, b, y, N, H, W, *args, stream)``
    on a CUDA one (H, W: the input's)."""
    if x.dim() != 4 or x.shape[-1] not in cins:
        raise ValueError(f"{name}: x must be NHWC with C in {cins}, got "
                         f"{tuple(x.shape)}")
    if (tuple(p.w.shape) != (cout, x.shape[-1], 3, 3)
            or tuple(p.b.shape) != (cout,)):
        raise ValueError(f"{name}: weights must be ({cout}, {x.shape[-1]}, 3, "
                         f"3) OIHW + ({cout},), got {tuple(p.w.shape)}, "
                         f"{tuple(p.b.shape)}")
    n, h, wd, _ = x.shape
    if h < 2 or wd < 2:
        raise ValueError(f"{name}: reflect padding needs H, W >= 2")
    if not (x.device == p.w.device == p.b.device):
        raise ValueError(f"{name}: operands on different devices")
    if x.device.type == "cpu":
        return conv3x3_plain(x, p, relu, pool, up)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    w = p.w_tc if name == "conv3x3_full" else p.w_hwio
    if w is None or (name == "conv3x3_full" and tuple(w.shape) != (
            x.shape[-1] // 8, 9, cout // 8, 32, 4)):
        raise ValueError(f"{name}: the kernel's weights are missing or of "
                         "another shape; pack them with codec.pack")
    if not (x.dtype == w.dtype == p.b.dtype == torch.float32):
        raise TypeError(f"{name}: the kernel takes float32 only")
    if up:
        oh, ow = 2 * h, 2 * wd
    elif pool:
        oh, ow = (h + 1) // 2, (wd + 1) // 2
    else:
        oh, ow = h, wd
    y = torch.empty((n, oh, ow, cout), device=x.device, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, "optex_" + name)(
        x.contiguous().data_ptr(), w.data_ptr(), p.b.data_ptr(),
        y.data_ptr(), n, h, wd, *[int(a) for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({lib.optex_error_string(rc).decode()})")
    LAUNCHES[name] += 1
    return y


# ---------------------------------------------------------------------------
# 1. conv3x3_p2 — replaces ops/pallas/codec.py:282 conv3x3_p2 (body
#    _conv_p2_kernel :244): the encoder conv1_2 (+ pool) and the decoder
#    128->64 conv. Operations-bound; see the module note.

def conv3x3_p2(x, p: Packed, relu: bool = True, pool: bool = False):
    """x (N, H, W, Cin), Cin in {64, 128} -> [relu] conv3x3_reflect (N, H, W,
    64), or its 2x2 ceil-mode max-pool when ``pool``."""
    return _conv("conv3x3_p2", x, p, (64, 128), 64, relu, pool,
                 args=(x.shape[-1], relu, pool))


# ---------------------------------------------------------------------------
# 2. conv3x3_full — replaces ops/pallas/codec.py:376 conv3x3_full (body
#    _conv_full_kernel :340): the encoder 64->128 and 128->128 (+ pool)
#    convs. Operations-bound: an implicit GEMM on mma.sync, 3xTF32, with
#    the weights of pack_tc.

def conv3x3_full(x, p: Packed, relu: bool = True, pool: bool = False):
    """x (N, H, W, Cin), Cin in {64, 128} -> [relu] conv3x3_reflect (N, H, W,
    128), or its 2x2 ceil-mode max-pool when ``pool``."""
    return _conv("conv3x3_full", x, p, (64, 128), 128, relu, pool,
                 args=(x.shape[-1], relu, pool))


# ---------------------------------------------------------------------------
# 3. upconv_p2 — replaces ops/pallas/codec.py:449 upconv_p2 (body
#    _upconv_kernel :424): ReLU(conv3x3_reflect(nearest_up_x2(x))) in the
#    decoder. Operations-bound. The TPU kernel folds the upsample into
#    per-phase 2x2 taps with edge padding; this one computes the fine-scale
#    conv directly (2.25x the folded FLOPs) from a shared-memory halo whose
#    indices are reflected at the fine scale and halved to the coarse one
#    (a fine reflection of a nearest-upsampled image is a coarse edge pad),
#    so the 4x upsampled tensor is never written to device memory.

def upconv_p2(x, p: Packed):
    """coarse x (N, Hc, Wc, C), C in {64, 128} -> relu(conv3x3_reflect(
    nearest_up_x2(x))) (N, 2Hc, 2Wc, C)."""
    c = x.shape[-1] if x.dim() == 4 else -1
    return _conv("upconv_p2", x, p, (64, 128), c, relu=True, up=True,
                 args=(c,))


# ---------------------------------------------------------------------------
# 4. final_to_rgb — replaces ops/pallas/codec.py:515 final_to_rgb (body
#    _final_kernel :491): the decoder-final 64->3 conv, no ReLU, with the
#    next stage's 1x1 RGB renorm folded into its weights (pack_final, the
#    math of pack_final_rgb :121). Bytes-bound: 64 input channels read once
#    per pixel, 3 written; 32x32-pixel tiles, one thread per 2x2 quad.

def final_to_rgb(x, p: Packed):
    """x (N, H, W, 64) -> conv3x3_reflect (N, H, W, 3), no ReLU; ``p`` from
    :func:`pack_final`."""
    return _conv("final_to_rgb", x, p, (64,), 3)


# ---------------------------------------------------------------------------
# 5. rgb_to_relu1 — replaces ops/pallas/codec.py:578 rgb_to_relu1 (body
#    _entry_kernel :551): the encoder-entry 3->64 conv + bias + ReLU on the
#    post-renorm RGB image. Bytes-bound on its 64-channel output: written
#    once, float4-wide; the 3-channel input is read once into shared memory.

def rgb_to_relu1(x, p: Packed):
    """x (N, H, W, 3) -> relu(conv3x3_reflect) (N, H, W, 64)."""
    return _conv("rgb_to_relu1", x, p, (3,), 64, relu=True)
