"""The two rotation products of every cdf/sort sliced-OT step
(``transport._sampled_step_with_rot``): the rotated (C, N) rows the
matchers take, with each row's range, and the matched rows rotated back.

* :func:`rotate_rows` ``(x (N, C), rot (C, C)) -> (rows (C, N), lo, hi)``:
  ``rows = rot.T @ x.T`` and ``lo, hi = torch.aminmax(rows, dim=1)``;
* :func:`unrotate_rows` ``(rows (C, N), rot) -> (N, C)``: ``rows.T @ rot.T``.

They replace no Pallas kernel: the JAX package leaves both products to XLA
at ``precision=HIGHEST`` (``optimaltextures_tpu/transport.py``). On the card
both run on one hand-written kernel pair (``csrc/rotgemm.cu``: tensor cores,
three TF32 products per f32 product, the rotation resident in shared memory
and the cloud streamed once; its header says what bounds them and what the
design does about it). The forward kernel also reduces each row's minimum
and maximum, so the cdf matcher needs no pass of its own over the rows
(``histmatch.cdf_match_rows(t_range=, s_range=)``).

Each wrapper:

* on a CPU tensor runs its plain version, the step's own expressions
  (:func:`rotate_rows_plain`, :func:`unrotate_rows_plain`);
* on a CUDA tensor launches the kernel on the current stream (forward: then
  the ranges' combine over blocks, ``rot_gemm_range``), with the tiling
  :func:`plan` picks for the observed C and N, or raises — nothing falls
  back;
* counts its launches in ``LAUNCHES[name]`` (plain versions do not count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import cuda_build

LAUNCHES = {"rotate_rows": 0, "unrotate_rows": 0}

MAX_C = 512
NBS = (8, 16, 24, 32, 48, 64, 88, 96)   # output channels a block (wgmma's N)
WG = 2                      # warpgroups a block, 64 samples each
SMEM_LIMIT = 232448         # a block's dynamic shared memory on the H100
SMEM_TWO = 115712           # each of two blocks on one SM (228 KB, 1 KB a block kept)
B_LIMIT = 150 * 1024        # the rotation slice's hi and lo planes at most
MAX_STAGES = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the step's expressions)


def rotate_rows_plain(x: torch.Tensor, rot: torch.Tensor):
    rows = rot.T @ x.T
    lo, hi = torch.aminmax(rows, dim=1)
    return rows, lo, hi


def unrotate_rows_plain(rows: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    return rows.T @ rot.T


# ---------------------------------------------------------------------------
# the tiling


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


class Plan(NamedTuple):
    """One launch's tiling: ``nb`` output channels a block (``slices`` of
    them cover C; block b takes slice b % slices), ``wg`` warpgroups of 64
    samples, a K chunk ``kc`` a stage, ``stages`` in the ring, ``grid``
    blocks and ``smem`` bytes of shared memory (``csrc/rotgemm.cu``
    optex_rot_gemm_smem)."""
    nb: int
    wg: int
    kc: int
    stages: int
    slices: int
    grid: int
    smem: int


def smem_bytes(forward: bool, c: int, nb: int, wg: int, kc: int,
               stages: int) -> int:
    """The kernel's dynamic shared memory: the rotation slice's hi and lo
    planes, the ring (forward stage rows at kc + 4 floats, back at 64 wg +
    8), in the forward product the tile transposed (NB rows of 64 wg + 4,
    half of them at a time at NB 96) and the warpgroups' ranges, in the
    back product of one slice the tile staged for its stores."""
    kp, nt = _up(c, 8), 64 * wg
    stage = nt * (kc + 4) if forward else kc * (nt + 8)
    th = 1 if nb < 96 else 2       # the forward tile transposed in th parts
    if forward:
        extra = nb // th * (nt + 4) + 2 * wg * nb
    else:                           # one slice: the back tile staged whole
        extra = nt * c if -(-c // nb) == 1 else 0
    return 4 * (2 * nb * kp + stages * stage + extra)


@functools.lru_cache(maxsize=1024)   # a run has a few dozen shapes; keep its host cost off
def plan(c: int, n: int, forward: bool, sms: int) -> Plan:
    """The tiling for C channels and N samples on a card of ``sms`` SMs:
    the fewest slices whose width (the narrowest of ``NBS`` that holds a
    slice) keeps the planes within ``B_LIMIT``; then the widest K chunk
    (up to 64; narrower chunks cost more barriers and copies than they save
    on the chip), at least 3 stages where they fit, two blocks an SM where
    NB <= 64 and they fit, then the most stages (up to 4); a grid of that
    many blocks an SM, a multiple of the slices."""
    if not 1 <= c <= MAX_C:
        raise ValueError(f"rotation GEMM: C must be 1..{MAX_C}, got {c}")
    kp = _up(c, 8)
    for want in range(1, MAX_C + 1):
        need = -(-c // want)
        nb = next((v for v in NBS if v >= need), None)
        if nb is not None and 8 * nb * kp <= B_LIMIT:
            break
    slices = -(-c // nb)
    tiles = -(-n // (64 * WG))
    best = None
    for per_sm, budget in ((2, SMEM_TWO), (1, SMEM_LIMIT)):
        if per_sm == 2 and nb > 64:
            continue
        for kc in (min(kp, 64), 32, 16, 8):
            if kc > kp:
                continue
            for stages in range(MAX_STAGES, 1, -1):
                smem = smem_bytes(forward, c, nb, WG, kc, stages)
                if smem > budget:
                    continue
                key = (kc, min(stages, 3), per_sm, stages)
                if best is None or key > best[0]:
                    per_slice = max(1, min(tiles, per_sm * sms // slices))
                    best = (key, Plan(nb, WG, kc, stages, slices,
                                      per_slice * slices, smem))
    if best is not None:
        return best[1]
    raise AssertionError(f"rotation GEMM: no tiling fits C = {c}")


# ---------------------------------------------------------------------------
# the library

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rotgemm")
    if not getattr(lib, "_optex_typed", False):
        lib.optex_rot_gemm.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _P]
        lib.optex_rot_gemm.restype = _I
        lib.optex_rot_gemm_smem.argtypes = [_I] * 6
        lib.optex_rot_gemm_smem.restype = _I
        lib.optex_rot_gemm_error_string.argtypes = [_I]
        lib.optex_rot_gemm_error_string.restype = ctypes.c_char_p
        lib._optex_typed = True
    return lib


def build() -> None:
    """Build and load the kernels now (they otherwise build at first use)."""
    _lib()


_SMS = {}


def _sms(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _check(name: str, cloud: torch.Tensor, rot: torch.Tensor, c: int) -> bool:
    """Validate the operands; True when they lie on the CPU (plain version),
    False for CUDA (kernel). Anything else raises."""
    if cloud.dim() != 2 or cloud.numel() == 0:
        raise ValueError(f"{name}: the cloud must be a non-empty 2-D tensor, got "
                         f"{tuple(cloud.shape)}")
    if tuple(rot.shape) != (c, c):
        raise ValueError(f"{name}: rot must be ({c}, {c}), got {tuple(rot.shape)}")
    if rot.device != cloud.device:
        raise ValueError(f"{name}: operands on different devices")
    if cloud.device.type == "cpu":
        return True
    if cloud.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {cloud.device}")
    if cloud.dtype != torch.float32 or rot.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 only")
    if c > MAX_C:
        raise ValueError(f"{name}: at most {MAX_C} channels, got {c}")
    if cloud.numel() // c > 2**31 - 2**16:
        raise ValueError(f"{name}: at most 2^31 - 2^16 samples")
    return False


def _launch(name: str, p: Plan, forward: bool, src, rot, dst, part, lo, hi,
            c: int, n: int) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = lib.optex_rot_gemm(int(forward), src.data_ptr(), rot.data_ptr(),
                            dst.data_ptr(), ptr(part), ptr(lo), ptr(hi), c, n,
                            p.nb, p.wg, p.kc, p.stages, p.grid, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({lib.optex_rot_gemm_error_string(rc).decode()})")
    LAUNCHES[name] += 1


def rotate_rows(x: torch.Tensor, rot: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, C) samples, (C, C) rotation -> (``rot.T @ x.T`` as contiguous
    (C, N) rows, each row's minimum (C,), each row's maximum (C,))."""
    c = x.shape[-1] if x.dim() == 2 else -1
    if _check("rotate_rows", x, rot, c):
        return rotate_rows_plain(x, rot)
    x, rot = x.contiguous(), rot.contiguous()
    n = x.shape[0]
    rows = torch.empty((c, n), device=x.device, dtype=torch.float32)
    lo = torch.empty((c,), device=x.device, dtype=torch.float32)
    hi = torch.empty((c,), device=x.device, dtype=torch.float32)
    p = plan(c, n, True, _sms(x.device))
    part = torch.empty((p.grid, 2, c), device=x.device, dtype=torch.float32)
    _launch("rotate_rows", p, True, x, rot, rows, part, lo, hi, c, n)
    return rows, lo, hi


def unrotate_rows(rows: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """(C, N) rows, (C, C) rotation -> ``rows.T @ rot.T``, contiguous (N, C)."""
    c = rows.shape[0] if rows.dim() == 2 else -1
    if _check("unrotate_rows", rows, rot, c):
        return unrotate_rows_plain(rows, rot)
    rows, rot = rows.contiguous(), rot.contiguous()
    n = rows.shape[1]
    out = torch.empty((n, c), device=rows.device, dtype=torch.float32)
    _launch("unrotate_rows", plan(c, n, False, _sms(rows.device)), False, rows,
            rot, out, None, None, None, c, n)
    return out
