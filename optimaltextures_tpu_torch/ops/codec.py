"""The codec conv kernels: the port of ``optimaltextures_tpu/ops/pallas/codec.py``.

The five Pallas kernels there compute one operation — a 3x3 reflect-padded
conv with bias, differing in channel counts, an optional nearest-x2 prologue
and an optional ReLU / 2x2 max-pool epilogue — in a TPU layout (batch in the
128 lanes, 2-pixel M-packing, 8-channel padded RGB, DMA-then-repair halos).
None of that layout carries over: here every kernel takes and returns NHWC
at any batch (``csrc/codec.cu``), in one of two functions, chosen by the
dtype of the packed weights:

* float32 (the reference's precision): float32 in and out;
* bfloat16 (``conv_dtype="bfloat16"``, the function the Pallas kernels
  compute on the TPU): bf16 activations and weights, f32 accumulation, an
  f32 bias, ReLU and pool in f32, one rounding to bf16 at the store.
  ``rgb_to_relu1`` reads f32 RGB and rounds it to bf16 before multiplying;
  ``final_to_rgb`` reads bf16 features and writes f32 RGB. The bf16
  kernels count their launches under ``<name>_bf16``.

Each wrapper below:

* on a CPU tensor runs its plain PyTorch version (:func:`conv3x3_plain`
  with the wrapper's flags; the CPU tests hold it against the JAX kernels
  in interpret mode);
* on a CUDA tensor launches its kernel on the current stream, or raises —
  nothing falls back;
* takes ``pad="reflect"`` (the reference's padding) or ``pad="wrap"``
  (circular: tileable runs). The Pallas kernels reflect only, and the JAX
  package leaves tileable runs to XLA's convs; here every kernel has a
  wrap instantiation (a compile-time mode: the reflect instantiations are
  the code they were), whose halo reads the far edge of the image;
* counts its launches in ``LAUNCHES[name]``, ``name`` with ``_bf16`` for
  the bf16 function and ``_wrap`` for the wrap mode (plain versions do not
  count).

What bounds them on the H100 (67 TFLOP/s FFMA, 495 TFLOP/s dense TF32 on
the tensor cores and 3.35 TB/s HBM on the SXM part), and what the design
does about it:

* ``conv3x3_p2``, ``conv3x3_full`` and ``upconv_p2`` (64/128 channels in and
  out) do 2*9*Cin FLOPs per output value (upconv 2*4*Cin, folded) against
  5-12 bytes of pixel traffic, ~100-460 FLOP/B, above the card's ridge (148
  FLOP/B at the TF32 rate) even before three products triple the work:
  operations-bound. In float32 they run on the tensor cores as implicit
  GEMMs on ``mma.sync``, three TF32 products per f32 product (hi*hi + hi*lo
  + lo*hi; one TF32 product misses the 2e-5 bound), with the weights split
  hi/lo once at pack time in the kernels' fragment order (:func:`pack_tc`).
  The upconv folds its nearest-x2 upsample into 2x2 taps per output phase
  on the edge-padded coarse image (:func:`fold_up`, the math of the JAX
  package's ``pack_upconv_fold``): 4 taps per fine pixel, not 9. In
  bfloat16 all three run on ``wgmma``, as two modes of one kernel
  (``csrc/conv_wg.cu``): each block keeps one kind's weights resident in
  shared memory (a 64-channel co half of the conv, :func:`pack_wg`; an
  output phase and co half of the upconv's folded taps, :func:`pack_wg_up`)
  and walks column strips of rows through a ring of halo rows.
* ``rgb_to_relu1`` (3 -> 64) and ``final_to_rgb`` (64 -> 3) do 54 / 1152
  FLOPs per 4+256 / 256+12 bytes of pixel traffic: bytes-bound (0.021 ms
  of bytes against 0.0135 ms of FMAs at 512^2). Persistent over 16 x 16
  tiles, with the 64-channel side moved by TMA in the 128-byte-swizzled
  layout: ``final_to_rgb`` streams its input through a 3-slot ring and
  repairs the reflect halo in shared memory; ``rgb_to_relu1`` stages its
  output tile and stores it by TMA while the next tile computes. In
  float32 they are FFMA direct convs (``csrc/codec.cu``). In bfloat16 the
  FMAs on the FP32 cores would outlast the halved bytes, so the products
  run on bf16 ``mma.sync`` with the weights in registers (:func:`pack_edge`,
  ``csrc/edge_mma.cu``): ``rgb_to_relu1`` as an implicit GEMM over the
  tile's pixels, ``final_to_rgb`` as one product per halo pixel (all 27
  (tap, co) columns) followed by a 9-tap shift-sum. The next stage's
  renorm is folded into the final conv's weights (:func:`pack_final`), so
  no padded or renormalised copy ever reaches device memory. TMA needs a
  16-byte-aligned base: ``final_to_rgb`` raises on an input that is not.

Each conv's weights are packed once (:func:`pack`, :func:`pack_up`,
:func:`pack_final`, as the JAX package's ``pack_*``): OIHW for the plain
version, an HWIO copy for the two f32 FFMA kernels, for the wide convs the
f32 tensor-core fragments or the bf16 wgmma kernel's shared-memory image,
and for the narrow ones in bf16 the ``mma.sync`` B fragments.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .convops import to_nchw, to_nhwc

KERNELS = ("rgb_to_relu1", "conv3x3_p2", "conv3x3_full", "upconv_p2",
           "final_to_rgb")
LAUNCHES = {k + dt + pad: 0 for k in KERNELS for dt in ("", "_bf16")
            for pad in ("", "_wrap")}
PADS = ("reflect", "wrap")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Packed(NamedTuple):
    """One conv's weights: ``w`` (Cout, Cin, 3, 3) OIHW in the conv dtype
    and ``b`` (Cout,) float32 (a bf16 bias widens exactly) for the plain
    version, ``w_hwio`` (3, 3, Cin, Cout) float32 (widened exactly from
    bf16) for the FFMA kernels, and for the f32 tensor-core kernels the
    weights in fragment order: ``w_tc`` for a 64|128 -> 64|128 conv
    (:func:`pack_tc`), ``w_up`` for an upconv's folded taps (:func:`pack_up`);
    None where the conv has none. ``w_fold``: an upconv's folded taps
    (:func:`fold_up`) in the conv dtype, which the bf16 plain version
    computes with. ``w_wg``: a bf16 64|128 -> 64|128 conv's or upconv's
    weights as the wgmma kernel's shared-memory image (:func:`pack_wg`,
    :func:`pack_wg_up`), in place of ``w_tc`` / ``w_up``. ``w_edge``: a
    bf16 3 -> 64 or 64 -> 3 conv's weights as the ``mma.sync`` kernels' B
    fragments (:func:`pack_edge`)."""
    w: torch.Tensor
    b: torch.Tensor
    w_hwio: torch.Tensor
    w_tc: Optional[torch.Tensor] = None
    w_up: Optional[torch.Tensor] = None
    w_fold: Optional[torch.Tensor] = None
    w_wg: Optional[torch.Tensor] = None
    w_edge: Optional[torch.Tensor] = None


def pack(w: torch.Tensor, b: torch.Tensor) -> Packed:
    """A conv's weights for the plain version, and for the kernel that runs
    it when Cin and Cout are both 64 or 128: ``w_wg`` in bf16 (the wgmma
    kernel's image), ``w_tc`` in f32; a bf16 (Cin, Cout) of (3, 64) or (64,
    3) also gets ``w_edge`` (:func:`pack_edge`)."""
    w_hwio = w.permute(2, 3, 1, 0).contiguous()
    cout, cin = w.shape[:2]
    if w.dtype == torch.bfloat16 and (cin, cout) in ((3, 64), (64, 3)):
        return Packed(w, b.float(), w_hwio.float(), w_edge=pack_edge(w_hwio))
    if cout not in (64, 128) or cin not in (64, 128):
        return Packed(w, b.float(), w_hwio.float())
    if w.dtype == torch.bfloat16:
        return Packed(w, b.float(), w_hwio.float(), w_wg=pack_wg(w_hwio))
    return Packed(w, b.float(), w_hwio.float(), pack_tc(w_hwio))


def _edge_matrix(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO, (Cin, Cout) (3, 64) or (64, 3) -> the B
    operand of the bf16 ``mma.sync`` kernels in ``csrc/edge_mma.cu``,
    zero-padded to whole k16 steps and n8 tiles: for ``rgb_to_relu1``
    (3 -> 64) B[3 tap + ci][co] (32 x 64, rows 27-31 zero), for
    ``final_to_rgb`` (64 -> 3) B[ci][3 tap + co] (64 x 32, columns 27-31
    zero), tap = 3 kh + kw."""
    _, _, cin, cout = w_hwio.shape
    if (cin, cout) == (3, 64):
        m = w_hwio.reshape(27, 64)
        return torch.cat([m, m.new_zeros(5, 64)])
    if (cin, cout) == (64, 3):
        m = w_hwio.reshape(9, 64, 3).permute(1, 0, 2).reshape(64, 27)
        return torch.cat([m, m.new_zeros(64, 5)], 1)
    raise ValueError(f"_edge_matrix: (3, 3, 3, 64) or (3, 3, 64, 3) weights only, "
                     f"got {tuple(w_hwio.shape)}")


def pack_edge(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) bf16 HWIO, (Cin, Cout) (3, 64) or (64, 3) -> the
    B fragments of :func:`_edge_matrix`'s (K, N) matrix, (K/16, N/16, 32, 8)
    bf16: per k16 step s, pair of n8 tiles jp and lane (g = lane // 4, t =
    lane % 4) the lane's 16 bytes, registers {b0, b1} of n8 tile 2 jp, then
    of 2 jp + 1, where b0 holds B[16 s + 2 t][n], B[16 s + 2 t + 1][n] and
    b1 B[16 s + 2 t + 8][n], B[16 s + 2 t + 9][n], n = 8 j + g (the lower k
    in the low half). A lane's 32 registers are eight 16-byte loads."""
    if w_hwio.dtype != torch.bfloat16:
        raise ValueError(f"pack_edge: bf16 weights only, got {w_hwio.dtype}")
    m = _edge_matrix(w_hwio)
    k, n = m.shape
    # (s, half, t, e, jp, jj, g) -> (s, jp, g, t, jj, half, e)
    t = m.reshape(k // 16, 2, 4, 2, n // 16, 2, 8).permute(0, 4, 6, 2, 5, 1, 3)
    return t.reshape(k // 16, n // 16, 32, 8).contiguous()


def pack_up(w: torch.Tensor, b: torch.Tensor) -> Packed:
    """An upconv's weights (nearest-x2 then this conv, C -> C): the folded
    taps of :func:`fold_up` (``w_fold``) and, for ``upconv_p2``, the same
    in f32 fragments (``w_up``) or as the bf16 wgmma kernel's image
    (``w_wg``, :func:`pack_wg_up`)."""
    w_hwio = w.permute(2, 3, 1, 0).contiguous()
    fold = fold_up(w_hwio)
    if w.dtype == torch.bfloat16:
        return Packed(w, b.float(), w_hwio.float(), w_fold=fold, w_wg=pack_wg_up(fold))
    taps = fold.permute(0, 2, 1, 3, 4, 5).reshape(16, *w_hwio.shape[2:])
    return Packed(w, b.float(), w_hwio.float(), w_up=_fragments(taps), w_fold=fold)


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


def _fragments(taps: torch.Tensor) -> torch.Tensor:
    """(T, Cin, Cout) float32 taps -> (Cin/8, T, Cout/8, 32, 4), the B
    operands of the tensor-core kernels: per input-channel chunk c of 8 (one
    k8 step), tap, n8 tile j and lane (g = lane // 4, t = lane % 4) the
    lane's fragments {hi(k), hi(k + 4), lo(k), lo(k + 4)} of
    ``taps[tap, 8c + k, 8j + g]`` at k = t (:func:`split_tf32`), so one chunk
    is one contiguous block and a lane's fragment one 16-byte load."""
    n, cin, cout = taps.shape
    hi, lo = split_tf32(taps.reshape(n, cin // 8, 2, 4, cout // 8, 8))
    # (tap, c, k-half, t, j, g) -> (c, tap, j, g, t, [hi0, hi1, lo0, lo1])
    frag = torch.stack([hi[:, :, 0], hi[:, :, 1], lo[:, :, 0], lo[:, :, 1]], -1)
    return frag.permute(1, 0, 3, 4, 2, 5).reshape(
        cin // 8, n, cout // 8, 32, 4).contiguous()


def pack_tc(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) float32 HWIO -> the f32 weights of ``conv3x3_p2``
    (Cout 64) and ``conv3x3_full`` (Cout 128) in fragment order, tap 3r + s:
    (Cin/8, 9, Cout/8, 32, 4) split (:func:`_fragments`). (bf16 weights go
    to the wgmma kernel: :func:`pack_wg`.)"""
    _, _, cin, cout = w_hwio.shape
    if w_hwio.dtype != torch.float32:
        raise ValueError(f"pack_tc: float32 weights only, got {w_hwio.dtype}")
    return _fragments(w_hwio.reshape(9, cin, cout))


def _wg_image(taps: torch.Tensor) -> torch.Tensor:
    """(T, Cin, Cout) bf16 taps -> (Cout/64, T, Cin/64, 64, 64) bf16: per
    64-channel output half h, the A operand of the wgmma kernel
    (``csrc/conv_wg.cu``) byte for byte as it lies in shared memory:
    [tap][k-block kb][co][64 ci], K-major. Row co of block (tap, kb) is 128
    bytes, input channels 64 kb .. 64 kb + 63 of output channel 64 h + co;
    its 16-byte chunk c (channels 8c .. 8c + 7) is stored at chunk c ^ (co %
    8): the 128-byte swizzle a wgmma descriptor of layout type 1 reads,
    8-row groups 1024 bytes apart."""
    n, cin, cout = taps.shape
    # (tap, kb, c, e, h, co) -> (h, tap, kb, co, c, e)
    t = taps.reshape(n, cin // 64, 8, 8, cout // 64, 64).permute(4, 0, 1, 5, 2, 3)
    # stored chunk c' of row co holds chunk c' ^ (co % 8) (its own inverse)
    co = torch.arange(64, device=taps.device).reshape(64, 1)
    chunk = torch.arange(8, device=taps.device).reshape(1, 8) ^ (co % 8)
    idx = chunk.reshape(1, 1, 1, 64, 8, 1).expand(cout // 64, n, cin // 64, 64, 8, 8)
    return t.gather(4, idx).reshape(cout // 64, n, cin // 64, 64, 64).contiguous()


def pack_wg(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) bf16 HWIO, Cin and Cout 64 or 128 -> (Cout/64, 9,
    Cin/64, 64, 64) bf16: the A operand of ``conv3x3_p2``'s and
    ``conv3x3_full``'s wgmma kernel, one image per kind of block (co half),
    taps 3r + s (:func:`_wg_image`)."""
    _, _, cin, cout = w_hwio.shape
    if w_hwio.dtype != torch.bfloat16 or cout not in (64, 128) or cin not in (64, 128):
        raise ValueError(f"pack_wg: bf16 (3, 3, 64|128, 64|128) weights only, got "
                         f"{w_hwio.dtype} {tuple(w_hwio.shape)}")
    return _wg_image(w_hwio.reshape(9, cin, cout))


def pack_wg_up(fold: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, 2, C, C) bf16 folded taps [a, b, u, v] (:func:`fold_up`), C
    64 or 128 -> (4 C/64, 4, C/64, 64, 64) bf16: the A operand of
    ``upconv_p2``'s wgmma kernel, one image per kind of block, kind (2a + b)
    C/64 + h for output phase (a, b) and co half h, taps 2u + v
    (:func:`_wg_image`). The taps are ``fold_up``'s bf16 sums, so the image is
    bit-equal to JAX's ``pack_upconv_fold``."""
    c = fold.shape[-1]
    if fold.dtype != torch.bfloat16 or tuple(fold.shape) != (2, 2, 2, 2, c, c) \
            or c not in (64, 128):
        raise ValueError(f"pack_wg_up: bf16 (2, 2, 2, 2, 64|128, 64|128) folded "
                         f"taps only, got {fold.dtype} {tuple(fold.shape)}")
    return torch.cat([_wg_image(fold[a, b].reshape(4, c, c))
                      for a in (0, 1) for b in (0, 1)])


def fold_up(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO -> (2, 2, 2, 2, Cin, Cout) folded taps [a, b,
    u, v]: nearest-x2 upsample, reflect pad and this conv equal, at fine
    pixel (2i + a, 2j + b), a 2x2 conv of the EDGE-padded coarse image at
    rows i + a - 1 + u, columns j + b - 1 + v (a fine-scale reflection of a
    nearest-upsampled image is a coarse-scale edge pad). Under wrap padding
    the same taps apply to the circularly padded coarse image: fine row -1
    wraps to fine row 2 Hc - 1, which is coarse row Hc - 1. Row phase a = 0
    takes coarse rows (i - 1, i) with weight rows (W0, W1 + W2), a = 1
    takes (i, i + 1) with (W0 + W1, W2); columns fold the same way. Summed
    in the dtype given, rows first, then columns: the folded taps are
    bit-equal to JAX's ``pack_upconv_fold`` in float32, and in bfloat16,
    where each sum rounds to bf16 as it does there."""
    w = w_hwio
    rows = (torch.stack([w[0], w[1] + w[2]]),        # a = 0: (u, s, ci, co)
            torch.stack([w[0] + w[1], w[2]]))        # a = 1
    return torch.stack([
        torch.stack([torch.stack([r[:, 0], r[:, 1] + r[:, 2]], 1),   # b = 0
                     torch.stack([r[:, 0] + r[:, 1], r[:, 2]], 1)])  # b = 1
        for r in rows])


def pack_final(w_fin: torch.Tensor, b_fin: torch.Tensor,
               renorm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Packed:
    """The decoder-final conv (w_fin (3, 64, 3, 3), b_fin (3,)) with the next
    stage's encoder 1x1 RGB renorm (w (3, 3, 1, 1), b (3,)) folded in: both
    are linear with nothing between them in a stage roundtrip (the math of
    the JAX package's ``pack_final_rgb``). ``None`` (the pass's last decode)
    leaves the final conv as it is. In bfloat16 the fold rounds as
    the JAX package's does: the einsum's result, ``rn @ b_fin`` and the sum
    each round to bf16 (the bias then widens to float32)."""
    if renorm is not None:
        rn = renorm[0][:, :, 0, 0]                     # (out, in)
        w_fin, b_fin = (torch.einsum("ok,kirc->oirc", rn, w_fin),
                        renorm[1] + rn @ b_fin)
    return pack(w_fin, b_fin)


# ---------------------------------------------------------------------------
# the library

_P = ctypes.c_void_p
_I = ctypes.c_int
# (x, w, b, y, n, h, w, [cin, relu, pool | c], wrap, stream)
_ARGTYPES = {
    "optex_rgb_to_relu1": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "optex_conv3x3_p2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "optex_conv3x3_full": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "optex_upconv_p2": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "optex_final_to_rgb": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_ARGTYPES.update({k + "_bf16": v for k, v in _ARGTYPES.items()})
# the kernels whose entry point is in a library of its own
# (csrc/<source>.cu); the others' are in csrc/codec.cu
_SOURCES = {**{k + "_bf16": "conv_wg" for k in ("conv3x3_p2", "conv3x3_full", "upconv_p2")},
            **{k + "_bf16": "edge_mma" for k in ("final_to_rgb", "rgb_to_relu1")}}


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library holding kernel ``name``'s entry point (each
    library has its own ``optex_error_string``)."""
    source = _SOURCES.get(name, "codec")
    lib = cuda_build.load(source)
    if not getattr(lib, "_optex_typed", False):
        for fn, argtypes in _ARGTYPES.items():
            if _SOURCES.get(fn[len("optex_"):], "codec") == source:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
        lib.optex_error_string.argtypes = [_I]
        lib.optex_error_string.restype = ctypes.c_char_p
        lib._optex_typed = True
    return lib


def build() -> None:
    """Build and load the kernels now (they otherwise build at first use),
    the libraries in parallel (:func:`cuda_build.load`)."""
    for name in ("conv3x3_p2", *_SOURCES):
        _lib(name)


def conv3x3_plain(x: torch.Tensor, p: Packed, relu: bool = False,
                  pool: bool = False, up: bool = False,
                  out_dtype: Optional[torch.dtype] = None,
                  pad: str = "reflect") -> torch.Tensor:
    """The plain PyTorch version of every kernel here: NHWC x ->
    [2x2 ceil max-pool] [relu] conv3x3_<pad>([nearest_up_x2] x), NHWC,
    ``pad`` "reflect" or "wrap" (circular). bfloat16 weights take
    :func:`conv3x3_plain_bf16` (``out_dtype``: its result's dtype, default
    bfloat16). A batch whose padded activations would pass 2^31 elements
    runs in pieces of images (PyTorch's reflect pad takes 32-bit index math
    only; the circular pad is cut the same way)."""
    n, h, w, _ = x.shape
    per_image = (max(x.shape[-1], p.w.shape[0]) * (2 * h + 2 if up else h + 2)
                 * (2 * w + 2 if up else w + 2))
    if n > 1 and n * per_image >= 2 ** 31:
        step = max(1, (2 ** 31 - 1) // per_image)
        return torch.cat([conv3x3_plain(x[i:i + step], p, relu, pool, up,
                                        out_dtype, pad)
                          for i in range(0, n, step)])
    if p.w.dtype == torch.bfloat16:
        return conv3x3_plain_bf16(x, p, relu, pool, up,
                                  out_dtype or torch.bfloat16, pad)
    t = to_nchw(x)
    if up:
        t = F.interpolate(t, scale_factor=2, mode="nearest")
    t = F.conv2d(F.pad(t, (1, 1, 1, 1), mode=_torch_pad(pad)), p.w, p.b)
    if relu:
        t = torch.relu(t)
    if pool:
        t = F.max_pool2d(t, 2, 2, ceil_mode=True)
    return to_nhwc(t)


def _torch_pad(pad: str) -> str:
    """The ``F.pad`` mode of a pad mode."""
    if pad not in PADS:
        raise ValueError(f"pad must be reflect|wrap, got {pad!r}")
    return "reflect" if pad == "reflect" else "circular"


def folded_upconv(t: torch.Tensor, fold: torch.Tensor,
                  pad: str = "reflect") -> torch.Tensor:
    """NCHW coarse t (N, C, Hc, Wc) -> the conv of its nearest-x2 upsample
    (N, Cout, 2 Hc, 2 Wc), no bias, computed as :func:`fold_up`'s 2x2 taps
    ``fold`` (a, b, u, v, ci, co) per output phase on the coarse image
    padded by one pixel: edge-padded for ``pad="reflect"``, circularly for
    ``pad="wrap"``. Sums in ``t``'s dtype."""
    n, _, hc, wc = t.shape
    tp = F.pad(t, (1, 1, 1, 1), mode="replicate" if pad == "reflect"
               else _torch_pad(pad))
    t = torch.stack([torch.stack([
        F.conv2d(tp[:, :, a:a + hc + 1, b:b + wc + 1],
                 fold[a, b].permute(3, 2, 0, 1)) for b in (0, 1)], -1)
        for a in (0, 1)], 3)                           # (n, co, hc, a, wc, b)
    return t.reshape(n, -1, 2 * hc, 2 * wc)


def conv3x3_plain_bf16(x: torch.Tensor, p: Packed, relu: bool = False,
                       pool: bool = False, up: bool = False,
                       out_dtype: torch.dtype = torch.bfloat16,
                       pad: str = "reflect") -> torch.Tensor:
    """The bf16 kernels' function, as the Pallas kernels compute it: x
    rounded to bf16 (a no-op on bf16 features; ``rgb_to_relu1``'s f32 RGB
    rounds here), x and the bf16 weights widened to f32, the conv in f32
    plus the f32 bias, [relu], [pool], then one rounding to ``out_dtype``.
    The upconv convolves with its folded bf16 taps (``p.w_fold``: the sums
    rounded to bf16, as ``pack_upconv_fold`` rounds them) on the
    edge-padded (under wrap: circularly padded) coarse image, per output
    phase (:func:`folded_upconv`)."""
    t = to_nchw(x.to(torch.bfloat16).float())
    if up:
        t = folded_upconv(t, p.w_fold.float(), pad) + p.b[:, None, None]
    else:
        t = F.conv2d(F.pad(t, (1, 1, 1, 1), mode=_torch_pad(pad)),
                     p.w.float(), p.b)
    if relu:
        t = torch.relu(t)
    if pool:
        t = F.max_pool2d(t, 2, 2, ceil_mode=True)
    return to_nhwc(t).to(out_dtype)


# per kernel (the bf16 one where it differs): the Packed field it takes, its
# taps (None: HWIO) and the function that packs them
_WEIGHTS = {"conv3x3_p2": ("w_tc", 9, "pack"), "conv3x3_full": ("w_tc", 9, "pack"),
            "upconv_p2": ("w_up", 16, "pack_up"),
            "conv3x3_p2_bf16": ("w_wg", 9, "pack"),
            "conv3x3_full_bf16": ("w_wg", 9, "pack"),
            "upconv_p2_bf16": ("w_wg", 4, "pack_up"),
            "final_to_rgb_bf16": ("w_edge", None, "pack"),
            "rgb_to_relu1_bf16": ("w_edge", None, "pack")}
# the kernels that read their input by TMA (the outputs are allocated here)
_TMA_INPUT = ("final_to_rgb",)


def _conv(name: str, x: torch.Tensor, p: Packed, cins, cout: int,
          relu: bool = False, pool: bool = False, up: bool = False,
          args=(), pad: str = "reflect") -> torch.Tensor:
    """Validate the operands, then run the plain version on a CPU tensor or
    launch the kernel ``optex_<name>[_bf16](x, w, b, y, N, H, W, *args,
    wrap, stream)`` on a CUDA one (H, W: the input's); the weights' dtype
    picks the function, ``pad`` its halo (wrap = 1: circular)."""
    if pad not in PADS:
        raise ValueError(f"{name}: pad must be reflect|wrap, got {pad!r}")
    if x.dim() != 4 or x.shape[-1] not in cins:
        raise ValueError(f"{name}: x must be NHWC with C in {cins}, got "
                         f"{tuple(x.shape)}")
    if (tuple(p.w.shape) != (cout, x.shape[-1], 3, 3)
            or tuple(p.b.shape) != (cout,)):
        raise ValueError(f"{name}: weights must be ({cout}, {x.shape[-1]}, 3, "
                         f"3) OIHW + ({cout},), got {tuple(p.w.shape)}, "
                         f"{tuple(p.b.shape)}")
    n, h, wd, _ = x.shape
    scale = 2 if up else 1
    if pad == "reflect" and (scale * h < 2 or scale * wd < 2):
        raise ValueError(f"{name}: reflect padding needs H, W >= 2 at the "
                         "conv's resolution")
    if h < 1 or wd < 1:
        raise ValueError(f"{name}: empty image {tuple(x.shape)}")
    if not (x.device == p.w.device == p.b.device):
        raise ValueError(f"{name}: operands on different devices")
    bf16 = p.w.dtype == torch.bfloat16
    out_dtype = (torch.bfloat16 if bf16 and name != "final_to_rgb"
                 else torch.float32)
    if x.device.type == "cpu":
        return conv3x3_plain(x, p, relu, pool, up, out_dtype, pad)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if p.w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernels take float32 or bfloat16 "
                        f"weights, got {p.w.dtype}")
    in_dtype = torch.float32 if name == "rgb_to_relu1" else p.w.dtype
    if x.dtype != in_dtype or p.b.dtype != torch.float32:
        raise TypeError(f"{name}: {p.w.dtype} weights take a {in_dtype} input "
                        f"and a float32 bias, got {x.dtype} and {p.b.dtype}")
    field, taps, packer = _WEIGHTS.get(name + "_bf16" * bf16, _WEIGHTS.get(
        name, ("w_hwio", None, "pack")))
    w = getattr(p, field)
    if field == "w_wg":          # an image per kind of block (conv_wg.cu)
        shape = ((4 if up else 1) * cout // 64, taps, x.shape[-1] // 64, 64, 64)
    elif field == "w_edge":      # mma.sync B fragments (edge_mma.cu)
        shape = (2, 4, 32, 8) if cout == 64 else (4, 2, 32, 8)
    elif taps is not None:       # f32 fragments, one k8 step a chunk
        shape = (x.shape[-1] // 8, taps, cout // 8, 32, 4)
    if w is None or (field != "w_hwio" and (w.dtype != p.w.dtype
                                           or tuple(w.shape) != shape)):
        raise ValueError(f"{name}: the kernel's weights ({field}) are missing "
                         f"or of another shape; pack them with codec.{packer}")
    if up:
        oh, ow = 2 * h, 2 * wd
    elif pool:
        oh, ow = (h + 1) // 2, (wd + 1) // 2
    else:
        oh, ow = h, wd
    x = x.contiguous()
    if name in _TMA_INPUT and x.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned input, got "
                         f"address {x.data_ptr():#x}")
    y = torch.empty((n, oh, ow, cout), device=x.device, dtype=out_dtype)
    if bf16:
        name += "_bf16"
    lib = _lib(name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    wrap = pad == "wrap"
    rc = getattr(lib, "optex_" + name)(
        x.data_ptr(), w.data_ptr(), p.b.data_ptr(),
        y.data_ptr(), n, h, wd, *[int(a) for a in args], int(wrap), stream)
    if rc != 0:
        raise RuntimeError(f"{name}{'_wrap' * wrap}: kernel launch failed: "
                           f"CUDA error {rc} "
                           f"({lib.optex_error_string(rc).decode()})")
    LAUNCHES[name + "_wrap" * wrap] += 1
    return y


# ---------------------------------------------------------------------------
# 1. conv3x3_p2 — replaces ops/pallas/codec.py:282 conv3x3_p2 (body
#    _conv_p2_kernel :244): the encoder conv1_2 (+ pool) and the decoder
#    128->64 conv. Operations-bound. f32: conv3x3_tf32x3 at 64 output
#    channels, 3xTF32 on mma.sync, 16 x 16-pixel blocks, with the weights of
#    pack_tc. bf16: conv3x3_wg<64, CIN> (csrc/conv_wg.cu) on wgmma, all 64
#    co's weights resident a block (pack_wg), row pairs of a column strip
#    over a ring of halo rows.

def conv3x3_p2(x, p: Packed, relu: bool = True, pool: bool = False,
               pad: str = "reflect"):
    """x (N, H, W, Cin), Cin in {64, 128} -> [relu] conv3x3_<pad> (N, H, W,
    64), or its 2x2 ceil-mode max-pool when ``pool``."""
    return _conv("conv3x3_p2", x, p, (64, 128), 64, relu, pool,
                 args=(x.shape[-1], relu, pool), pad=pad)


# ---------------------------------------------------------------------------
# 2. conv3x3_full — replaces ops/pallas/codec.py:376 conv3x3_full (body
#    _conv_full_kernel :340): the encoder 64->128 and 128->128 (+ pool)
#    convs. Operations-bound. f32: conv3x3_tf32x3 at 128 output channels, 8 x
#    16-pixel blocks, with the weights of pack_tc. bf16: conv3x3_wg<128, CIN>
#    (csrc/conv_wg.cu) on wgmma, one co half's weights resident a block
#    (pack_wg), row pairs of a column strip over a ring of halo rows.

def conv3x3_full(x, p: Packed, relu: bool = True, pool: bool = False,
                 pad: str = "reflect"):
    """x (N, H, W, Cin), Cin in {64, 128} -> [relu] conv3x3_<pad> (N, H, W,
    128), or its 2x2 ceil-mode max-pool when ``pool``."""
    return _conv("conv3x3_full", x, p, (64, 128), 128, relu, pool,
                 args=(x.shape[-1], relu, pool), pad=pad)


# ---------------------------------------------------------------------------
# 3. upconv_p2 — replaces ops/pallas/codec.py:449 upconv_p2 (body
#    _upconv_kernel :424): ReLU(conv3x3_reflect(nearest_up_x2(x))) in the
#    decoder. Operations-bound. As the TPU kernel does, upconv_tf32x3 folds
#    the upsample into 2x2 taps per output phase on the edge-padded coarse
#    image (pack_up): 4 taps per fine pixel, not 9, and the 4x upsampled
#    tensor never exists. f32: 3xTF32 on mma.sync; a warp's two m16 tiles
#    are the two column phases of 16 coarse columns, which share their three
#    column-shifted input fragments. bf16: upconv_wg<C> (csrc/conv_wg.cu),
#    the wgmma conv's ring and K loop with 4 taps, a block per output phase
#    and co half with that kind's folded taps resident (pack_wg_up), each
#    output pixel's 64 channels stored as one 128-byte line.

def upconv_p2(x, p: Packed, pad: str = "reflect"):
    """coarse x (N, Hc, Wc, C), C in {64, 128} -> relu(conv3x3_<pad>(
    nearest_up_x2(x))) (N, 2Hc, 2Wc, C); ``p`` from :func:`pack_up`."""
    c = x.shape[-1] if x.dim() == 4 else -1
    return _conv("upconv_p2", x, p, (64, 128), c, relu=True, up=True,
                 args=(c,), pad=pad)


# ---------------------------------------------------------------------------
# 4. final_to_rgb — replaces ops/pallas/codec.py:515 final_to_rgb (body
#    _final_kernel :491): the decoder-final 64->3 conv, no ReLU, with the
#    next stage's 1x1 RGB renorm folded into its weights (pack_final, the
#    math of pack_final_rgb :121). Bytes-bound: 64 input channels read once
#    per pixel by TMA into a 3-slot ring of halo boxes (reflect halo repaired
#    in shared memory; in wrap mode an edge tile reads the image's far edge
#    into its box with plain loads) that a producer warp keeps filling, 3
#    written;
#    persistent over 16 x 16 tiles. f32: final_to_rgb_tma, each of 8 warps
#    4 channels of a half on the FP32 cores, the 8 warps' partial sums added
#    once per tile. bf16: final_to_rgb_mma (csrc/edge_mma.cu), every halo
#    pixel times all 27 (tap, co) columns on mma.sync (A by ldmatrix from
#    the ring slot, B = pack_edge's fragments in registers) into Z in shared
#    memory, then one thread per output pixel sums its 9 taps.

def final_to_rgb(x, p: Packed, pad: str = "reflect"):
    """x (N, H, W, 64) -> conv3x3_<pad> (N, H, W, 3), no ReLU; ``p`` from
    :func:`pack_final`."""
    return _conv("final_to_rgb", x, p, (64,), 3, pad=pad)


# ---------------------------------------------------------------------------
# 5. rgb_to_relu1 — replaces ops/pallas/codec.py:578 rgb_to_relu1 (body
#    _entry_kernel :551): the encoder-entry 3->64 conv + bias + ReLU on the
#    post-renorm RGB image. Bytes-bound on its 64-channel output: staged in
#    shared memory and written once by TMA bulk stores, double-buffered so a
#    tile's stores overlap the next tile's products; the 3-channel input is
#    read once by plain loads, one tile ahead. f32: rgb_to_relu1_tma, FFMA.
#    bf16: rgb_to_relu1_mma (csrc/edge_mma.cu), an implicit GEMM on mma.sync
#    (M = the tile's pixels, N = 64, K = 27 padded to 32), each lane's A
#    gathered from the staged bf16 halo, B = pack_edge's fragments in
#    registers.

def rgb_to_relu1(x, p: Packed, pad: str = "reflect"):
    """x (N, H, W, 3) -> relu(conv3x3_<pad>) (N, H, W, 64)."""
    return _conv("rgb_to_relu1", x, p, (3,), 64, relu=True, pad=pad)
