"""The cdf-matching kernels: the port of ``optimaltextures_tpu/ops/pallas/
histogram.py``, ``pwl_remap.py`` and ``cdf_remap.py``.

Every cdf-mode OT iteration (and each of the three pixel-space steps of
``color_transfer="opt"``, and each cross-matching of texture mixing in cdf
mode) bins the rotated target and style clouds into 256-bin shared-range
histograms (:func:`histogram_pair`, one launch for both clouds;
:func:`batched_histogram` is the one-cloud case and the counterpart of the
JAX function) and maps every target sample through the piecewise-linear
remap built from them (:func:`pwl_remap`, one launch). :func:`cdf_remap`
is the legacy fused apply (cdfs, remap table and per-sample map in one
launch); as in the JAX package, no path of the program calls it. All take
(C, N) rows, one channel per row, as the JAX functions do.

Each wrapper below:

* on a CPU tensor runs its plain PyTorch version (:func:`histogram_plain`,
  :func:`pwl_remap_plain`; the CPU tests hold them against the Pallas
  kernels in interpret mode and against the JAX package's XLA twins);
* on a CUDA tensor launches its kernel (``csrc/cdf.cu``) on the current
  stream, or raises — nothing falls back;
* counts its launches in ``LAUNCHES[name]`` (plain versions do not count).

What bounds them on the H100: all three are bytes-bound (a few dozen operations
per 4-byte sample against 3.35 TB/s). The TPU kernels turn the bin lookups
into one-hot contractions on the MXU (nibble one-hots, 8-channel blocks,
pad-with-lo then subtract); none of that carries over. Here the histogram
gives each (cloud, channel) row a thread-block cluster, counts with
shared-memory atomics into per-warp sub-histograms and sums the cluster's
tables through distributed shared memory into plain float stores (exact:
counts stay below 2^24; no zeroed output, no global atomics). The remap
builds its channel's segment table (edges, values, slopes) once per block
in shared memory and costs one division and one table read a sample. The
fused apply builds its channel's cdfs (warp-shuffle scans), edges, remap
table and segment table once per block the same way, and maps each sample
through a guessed segment that it verifies against the two edges around
it (exact, since the edges never decrease), with a binary search over the
edges only where the guess misses. All three split each row over as many
blocks as fill the card and read it with 16-byte loads. Each reads its
samples once and writes its result once.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

BINS = 256

LAUNCHES = {"batched_histogram": 0, "pwl_remap": 0, "cdf_remap": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the arithmetic the kernels repeat, op for op)


def histogram_plain(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    bins: int = BINS) -> torch.Tensor:
    """(C, N) samples + (C,) ranges -> (C, bins) float32 counts, torch.histc
    binning: ``trunc((x - lo) * bins / safe)`` clipped to [0, bins - 1],
    ``safe`` = the width, or 1 where the width is <= 0."""
    c = x.shape[0]
    width = hi - lo
    safe = torch.where(width > 0, width, torch.ones_like(width))
    idx = ((x - lo[:, None]) * bins / safe[:, None]).to(torch.int32)
    idx = idx.clamp(0, bins - 1).to(torch.int64)
    idx = idx + bins * torch.arange(c, device=x.device)[:, None]
    return torch.bincount(idx.reshape(-1), minlength=c * bins
                          ).reshape(c, bins).to(torch.float32)


def pwl_step(lo: torch.Tensor, hi: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """The uniform bin step ``(hi - lo) / bins`` the plain version bins
    with (one f32 value per channel); the kernel computes the same two
    rounded f32 operations itself."""
    return (hi - lo) / bins


def pwl_bin_index(t: torch.Tensor, lo: torch.Tensor, step_safe: torch.Tensor,
                  bins: int = BINS) -> torch.Tensor:
    """Arithmetic searchsorted(edges, t, 'left') for the uniform right
    edges lo + (j+1)*step: ``clip(ceil((t - lo) / step_safe) - 1, 0,
    bins - 1)``."""
    u = (t - lo[:, None]) / step_safe[:, None]
    return (torch.ceil(u).to(torch.int32) - 1).clamp(0, bins - 1)


def pwl_remap_plain(t: torch.Tensor, remapped: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """(C, N) samples -> ``interp_ref(t; right edges lo + (j+1)*step,
    remapped)`` per channel, with the segment index of
    :func:`pwl_bin_index` (the JAX package's ``_pwl_apply_rows``). The last
    segment maps to ``remapped[:, -1]``; a width <= 0 maps to
    ``remapped[:, 0]``.

    In the kernel's order: per channel, the right edges ``xp[j] = lo +
    (j+1)*step`` and the slopes ``(remapped[j+1] - remapped[j]) / (xp[j+1]
    - xp[j])`` first, then per sample ``slope[j] * (t - xp[j]) +
    remapped[j]`` by gathers. Each table entry is the same rounded f32
    operations on the same operands as the per-sample form, so the two are
    bit-equal (tests/test_torch_cdf_pair.py keeps that form as the oracle)."""
    bins = remapped.shape[1]
    width = hi - lo
    step = pwl_step(lo, hi, bins)
    step_safe = torch.where(step > 0, step, torch.ones_like(step))
    jf = torch.arange(1, bins + 1, dtype=t.dtype, device=t.device)
    xp = lo[:, None] + jf * step[:, None]                       # (C, bins)
    slope = (remapped[:, 1:] - remapped[:, :-1]) / (xp[:, 1:] - xp[:, :-1])
    j = pwl_bin_index(t, lo, step_safe, bins).to(torch.int64)
    js = j.clamp(max=bins - 2)      # the last segment has no slope
    f = (torch.gather(slope, 1, js) * (t - torch.gather(xp, 1, js))
         + torch.gather(remapped, 1, js))
    # j == bins-1: the reference's non-finite fallback chain lands on
    # remapped[-1] (the whole last bin maps to it)
    f = torch.where(j >= bins - 1, remapped[:, -1:], f)
    return torch.where((width > 0)[:, None], f, remapped[:, :1])


def interp_rows(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """The reference's interp on every row: (C, Q) queries ``x`` on (C, B)
    non-decreasing nodes ``xp`` with values ``fp``. The index is
    ``min(#(xp < x), B - 1)`` (a batched searchsorted 'left', which on
    sorted rows equals the JAX kernels' compare-count), ``idx_next =
    min(idx + 1, B - 1)``, and the linear map falls back from anchoring at
    xp[idx] to xp[idx_next] and then to fp[idx] where non-finite (duplicate
    nodes)."""
    b = xp.shape[1]
    idx = torch.searchsorted(xp.contiguous(), x.contiguous()).clamp(max=b - 1)
    nxt = (idx + 1).clamp(max=b - 1)
    xp_i, xp_n = torch.gather(xp, 1, idx), torch.gather(xp, 1, nxt)
    fp_i, fp_n = torch.gather(fp, 1, idx), torch.gather(fp, 1, nxt)
    slope = (fp_n - fp_i) / (xp_n - xp_i)
    f0 = slope * (x - xp_i) + fp_i
    f1 = slope * (x - xp_n) + fp_n
    return torch.where(torch.isfinite(f0), f0,
                       torch.where(torch.isfinite(f1), f1, fp_i))


def cdf_remap_plain(t: torch.Tensor, t_hist: torch.Tensor, s_hist: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The fused cdf apply, in the kernel's order: cdfs (cumsum, divided by
    the total), right edges ``lo + j * (width / 256)`` for j = 1..256 (``lo``
    where the width is <= 0), the remap table ``interp(t_cdf; s_cdf ->
    edges)``, then ``interp(t; edges -> remapped)`` (:func:`interp_rows`)."""
    bins = t_hist.shape[1]
    t_cdf = torch.cumsum(t_hist, dim=1)
    t_cdf = t_cdf / t_cdf[:, -1:]
    s_cdf = torch.cumsum(s_hist, dim=1)
    s_cdf = s_cdf / s_cdf[:, -1:]
    width = hi - lo
    j = torch.arange(1, bins + 1, dtype=t.dtype, device=t.device)
    edges = lo[:, None] + j * (width / bins)[:, None]
    edges = torch.where((width > 0)[:, None], edges, lo[:, None].expand_as(edges))
    return interp_rows(t, edges, interp_rows(t_cdf, s_cdf, edges))


# ---------------------------------------------------------------------------
# the library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "optex_batched_histogram": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "optex_pwl_remap": [_P, _P, _P, _P, _P, _I, _I, _P],
    "optex_cdf_remap": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("cdf")
    if not getattr(lib, "_optex_typed", False):
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        lib.optex_cdf_error_string.argtypes = [_I]
        lib.optex_cdf_error_string.restype = ctypes.c_char_p
        lib._optex_typed = True
    return lib


def build() -> None:
    """Build and load the kernels now (they otherwise build at first use)."""
    _lib()


def _check(name: str, rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
           *others: torch.Tensor, max_rows: int = 65535) -> bool:
    """Validate the operands; True when they lie on the CPU (plain version),
    False for CUDA (kernel, at most ``max_rows`` rows). Anything else
    raises."""
    if rows.dim() != 2 or rows.shape[0] < 1 or rows.shape[1] < 1:
        raise ValueError(f"{name}: samples must be (C, N), got {tuple(rows.shape)}")
    c = rows.shape[0]
    if tuple(lo.shape) != (c,) or tuple(hi.shape) != (c,):
        raise ValueError(f"{name}: lo/hi must be ({c},), got {tuple(lo.shape)}, "
                         f"{tuple(hi.shape)}")
    if any(o.device != rows.device for o in (lo, hi, *others)):
        raise ValueError(f"{name}: operands on different devices")
    if rows.device.type == "cpu":
        return True
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if any(o.dtype != torch.float32 for o in (rows, lo, hi, *others)):
        raise TypeError(f"{name}: the kernel takes float32 only")
    if c > max_rows:
        raise ValueError(f"{name}: at most {max_rows} channels, got {c}")
    return False


def _empty_aligned_like(t: torch.Tensor) -> torch.Tensor:
    """An empty (C, N) tensor with ``t``'s alignment modulo 16 bytes, so a
    kernel's 16-byte loads of t and stores of the output line up on every
    row (t is aligned on the path; a view that is not gets an output with
    the same offset)."""
    c, n = t.shape
    off = (t.data_ptr() % 16) // t.element_size()
    return torch.empty(c * n + off, device=t.device, dtype=t.dtype)[off:].view(c, n)


def _launch(name: str, device, *args) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, "optex_" + name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} "
                           f"({lib.optex_cdf_error_string(rc).decode()})")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# 6. batched_histogram — replaces ops/pallas/histogram.py:98
#    batched_histogram (body _hist_kernel :55). Bytes-bound.

def batched_histogram(x: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """(C, N) samples + (C,) lo/hi -> (C, 256) float32 counts (torch.histc
    binning on the shared range [lo, hi]): the one-cloud case of
    :func:`histogram_pair`."""
    if _check("batched_histogram", x, lo, hi):
        return histogram_plain(x, lo, hi)
    return _histograms(lo, hi, x)[0]


def histogram_pair(t: torch.Tensor, s: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor):
    """The two clouds of a cdf step, target (C, Nt) and source (C, Ns), on
    their shared (C,) ranges -> (t counts, s counts), each (C, 256) float32:
    :func:`batched_histogram` of each, in one launch on a GPU (counted in
    ``LAUNCHES["batched_histogram"]``: the same kernel)."""
    on_cpu = _check("histogram_pair", t, lo, hi)
    _check("histogram_pair", s, lo, hi, t)
    if on_cpu:
        return histogram_plain(t, lo, hi), histogram_plain(s, lo, hi)
    return _histograms(lo, hi, t, s)


def _histograms(lo: torch.Tensor, hi: torch.Tensor, *clouds: torch.Tensor):
    """One launch of the histogram kernel on one or two CUDA clouds."""
    c = clouds[0].shape[0]
    clouds = [x.contiguous() for x in clouds]
    lo, hi = lo.contiguous(), hi.contiguous()
    # every count is written (no zeroing): the kernel stores all 256 bins
    outs = [torch.empty((c, BINS), device=lo.device, dtype=torch.float32)
            for _ in clouds]
    x1, out1 = (clouds[1], outs[1]) if len(clouds) == 2 else (clouds[0], outs[0])
    _launch("batched_histogram", lo.device, clouds[0].data_ptr(), x1.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), outs[0].data_ptr(), out1.data_ptr(), c,
            clouds[0].shape[1], x1.shape[1], len(clouds))
    return tuple(outs)


# ---------------------------------------------------------------------------
# 7. pwl_remap — replaces ops/pallas/pwl_remap.py:74 pwl_remap (body
#    _pwl_kernel :43). Bytes-bound.

def pwl_remap(t: torch.Tensor, remapped: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """(C, N) samples + (C, 256) remap tables + (C,) shared range -> the
    matched (C, N) samples (see :func:`pwl_remap_plain`)."""
    if tuple(remapped.shape) != (t.shape[0] if t.dim() == 2 else -1, BINS):
        raise ValueError(f"pwl_remap: remapped must be (C, {BINS}), got "
                         f"{tuple(remapped.shape)}")
    if _check("pwl_remap", t, lo, hi, remapped):
        return pwl_remap_plain(t, remapped, lo, hi)
    c, n = t.shape
    t, remapped = t.contiguous(), remapped.contiguous()
    lo, hi = lo.contiguous(), hi.contiguous()
    out = _empty_aligned_like(t)
    _launch("pwl_remap", t.device, t.data_ptr(), remapped.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), c, n)
    return out


# ---------------------------------------------------------------------------
# 8. cdf_remap — replaces ops/pallas/cdf_remap.py:97 cdf_remap (body
#    _remap_kernel :70). Bytes-bound.

def cdf_remap(t: torch.Tensor, t_hist: torch.Tensor, s_hist: torch.Tensor,
              lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(C, N) target samples + (C, 256) target and source histograms on the
    shared range (C,) -> the matched (C, N) samples (see
    :func:`cdf_remap_plain`), bit-equal to it. Any C and N: no padding, and
    no 65535-channel limit (the grid is one-dimensional)."""
    c = t.shape[0] if t.dim() == 2 else -1
    for name, h in (("t_hist", t_hist), ("s_hist", s_hist)):
        if tuple(h.shape) != (c, BINS):
            raise ValueError(f"cdf_remap: {name} must be (C, {BINS}), got "
                             f"{tuple(h.shape)}")
    if _check("cdf_remap", t, lo, hi, t_hist, s_hist, max_rows=2**31 - 1):
        return cdf_remap_plain(t, t_hist, s_hist, lo, hi)
    n = t.shape[1]
    t, t_hist, s_hist = t.contiguous(), t_hist.contiguous(), s_hist.contiguous()
    lo, hi = lo.contiguous(), hi.contiguous()
    out = _empty_aligned_like(t)
    _launch("cdf_remap", t.device, t.data_ptr(), t_hist.data_ptr(),
            s_hist.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), c, n)
    return out
