"""The 64 -> 64 channel 3x3 conv prototype: the port of
``tools/pallas_conv_proto.py`` (``conv64_pallas``, ``pack_wrow``).

:func:`conv64` keeps the JAX layout at its public face: a pre-padded bf16
input (H+2, W+2, 64, B), batch innermost, and the tool's packed weights
wrow (3, 128, 256) bf16 -> ``relu(valid 3x3 conv)`` (H, W, 64, B) bf16, no
bias, accumulated in float32. No path of the program calls it; the port of
the tool (``optimaltextures_tpu_torch/tools/conv_proto.py``) checks and
times it.

The wrapper:

* on a CPU tensor runs its plain PyTorch version (:func:`conv64_plain`; the
  CPU tests hold it against the Pallas kernel in interpret mode);
* on a CUDA tensor launches its kernel (``csrc/conv64.cu``) on the current
  stream, or raises — nothing falls back;
* counts its launches in ``LAUNCHES["conv64"]`` (the plain version does
  not count).

What bounds it on the H100: at the tool's 512 px x 128 shape, bytes (4.33
GB in, 4.29 GB out: 2.57 ms at 3.35 TB/s), with the 2.47e12 operations
level with them at the bf16 tensor-core rate (2.50 ms). The kernel runs
each output pixel as one (64 co x 64 b) GEMM on wgmma, K = 9 taps x 64 ci,
with the weights (:func:`pack_tc`'s layout, built from ``wrow`` in shared
memory) resident per block and the input slabs brought in once each by TMA
into a ring that serves every pixel reading them (``csrc/conv64.cu``). A
batch that is not a multiple of 8 cannot be described to TMA (16-byte
strides) and takes the kernel's masked load path. The TPU kernel's th/tw
tiles and its MXU packing are TPU tiling and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

C = 64

LAUNCHES = {"conv64": 0}


def reset_launches() -> None:
    LAUNCHES["conv64"] = 0


def pack_wrow(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 64, 64) HWIO -> (3, 128, 256) in w's dtype, the tool's
    packing: ``wrow[r, 64s + co, 64c + ci] = w[r, c - s, ci, co]`` for the
    phases s in {0, 1} and window columns c in 0..3 (zero elsewhere)."""
    kh, _, cin, cout = w.shape
    wr = torch.zeros((kh, 2 * cout, 4 * cin), dtype=torch.float32,
                     device=w.device)
    wf = w.to(torch.float32)
    for s in (0, 1):
        for c in range(4):
            if 0 <= c - s <= 2:
                wr[:, s * cout:(s + 1) * cout, c * cin:(c + 1) * cin] = \
                    wf[:, c - s].permute(0, 2, 1)
    return wr.to(w.dtype)


def unpack_wrow(wrow: torch.Tensor) -> torch.Tensor:
    """(3, 128, 256) packed rows -> the (3, 3, 64, 64) HWIO weights, read
    from phase 0 (``wrow[r, co, 64s + ci] = w[r, s, ci, co]``), as the
    kernel reads them."""
    return wrow[:, :C, :3 * C].reshape(3, C, 3, C).permute(0, 2, 3, 1)


def pack_tc(wrow: torch.Tensor) -> torch.Tensor:
    """(3, 128, 256) packed rows -> (64, 576), the kernel's wgmma A operand:
    row co, column 64 tap + ci (tap = 3r + s) holds ``w[r, s, ci, co]``,
    K-major. The kernel assembles it from ``wrow``'s phase-0 rows into
    shared memory (128-byte swizzled) once per block."""
    return unpack_wrow(wrow).permute(3, 0, 1, 2).reshape(C, 9 * C)


def conv64_plain(xpad: torch.Tensor, wrow: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one float32 F.conv2d of the
    widened input with the kernel's weight matrix (:func:`pack_tc`), ReLU,
    one rounding to bf16. On a GPU the caller turns TF32 off
    (``core.full_f32_precision``)."""
    w = pack_tc(wrow).to(torch.float32).reshape(C, 3, 3, C).permute(0, 3, 1, 2)
    y = F.conv2d(xpad.to(torch.float32).permute(3, 2, 0, 1), w)   # (B, 64, H, W)
    return torch.relu(y).to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()


# ---------------------------------------------------------------------------
# the library


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("conv64")
    if not getattr(lib, "_optex_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.optex_conv64.argtypes = [p, p, p, i, i, i, p]
        lib.optex_conv64.restype = i
        lib.optex_conv64_error_string.argtypes = [i]
        lib.optex_conv64_error_string.restype = ctypes.c_char_p
        lib._optex_typed = True
    return lib


def build() -> None:
    """Build and load the kernel now (it otherwise builds at first use)."""
    _lib()


# ---------------------------------------------------------------------------
# 9. conv64 — replaces tools/pallas_conv_proto.py:109 conv64_pallas (body
#    _kernel :63). Bytes-bound at the tool's shape (operations level); wgmma
#    + TMA (B % 8 == 0) or wgmma + masked loads (any other B).

def conv64(xpad: torch.Tensor, wrow: torch.Tensor) -> torch.Tensor:
    """relu(valid 3x3 conv): xpad (H+2, W+2, 64, B) bf16 and wrow (3, 128,
    256) bf16 (:func:`pack_wrow`) -> (H, W, 64, B) bf16. Any H, W, B."""
    if xpad.dim() != 4 or xpad.shape[2] != C or min(xpad.shape[:2]) < 3 \
            or xpad.shape[3] < 1:
        raise ValueError("conv64: xpad must be (H+2, W+2, 64, B) with H, W, "
                         f"B >= 1, got {tuple(xpad.shape)}")
    if tuple(wrow.shape) != (3, 2 * C, 4 * C):
        raise ValueError(f"conv64: wrow must be (3, 128, 256), got "
                         f"{tuple(wrow.shape)}")
    if wrow.device != xpad.device:
        raise ValueError("conv64: operands on different devices")
    if xpad.device.type == "cpu":
        return conv64_plain(xpad, wrow)
    if xpad.device.type != "cuda":
        raise ValueError(f"conv64: no kernel for device {xpad.device}")
    if xpad.dtype != torch.bfloat16 or wrow.dtype != torch.bfloat16:
        raise TypeError("conv64: the kernel takes bfloat16 only")
    hp, wp, _, b = xpad.shape
    xpad, wrow = xpad.contiguous(), wrow.contiguous()
    out = torch.empty((hp - 2, wp - 2, C, b), dtype=torch.bfloat16,
                      device=xpad.device)
    lib = _lib()
    rc = lib.optex_conv64(xpad.data_ptr(), wrow.data_ptr(), out.data_ptr(),
                          hp - 2, wp - 2, b,
                          torch.cuda.current_stream(xpad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv64: kernel launch failed: CUDA error {rc} "
                           f"({lib.optex_conv64_error_string(rc).decode()})")
    LAUNCHES["conv64"] += 1
    return out
