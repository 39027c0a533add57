"""Histogram matching — the counterpart of
``optimaltextures_tpu/ops/histmatch.py``.

Moment matching (chol / pca / sym): first/second-moment matching through the
C x C channel covariance with the reference's eps=1 ridge. Everything stays
(..., C) sample-major so the big contractions are (N, C) GEMMs. Centering is
per (batch element, channel); the covariance pools all samples.

CDF matching (cdf): exact 1-D OT on 256 shared-range bins per channel, on
(C, N) rows. The two per-sample passes run on the CUDA kernels of
:mod:`.cdf` (histograms, PWL remap); the (C, 256, 256) remap-table work
stays plain PyTorch, as the JAX package leaves it to XLA. Sort matching
(sort): exact per-channel 1-D OT by order statistics.

Matmuls run in full float32: the port turns TF32 off on its f32 path
(``core.full_f32_precision``), the counterpart of the JAX package's
``precision=HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import cdf


def moment_stats(x: torch.Tensor, mesh=None, mean_mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) -> mu (B, 1, 1, C), pooled raw covariance (C, C).
    With a ``mesh`` (parallel.mesh.Mesh) ``x`` is this rank's shard: the
    Gram and the sample count are summed over the mesh's ranks (equal
    shards), so the covariance pools the global batch. The means are per
    image: local to the shard (batch DP), or with a ``mean_mesh`` (the
    ranks holding the other rows of the same images: spatial sharding, the
    grid's space axis) each image's sums are summed over it."""
    c = x.shape[-1]
    if mean_mesh is None:
        mu = x.mean(dim=(1, 2), keepdim=True)
    else:
        mu = mean_mesh.psum(x.sum(dim=(1, 2), keepdim=True)) / (
            x.shape[1] * x.shape[2] * mean_mesh.size)
    xc = (x - mu).reshape(-1, c)
    if mesh is None:
        return mu, (xc.T @ xc) / xc.shape[0]
    return mu, mesh.psum(xc.T @ xc) / (xc.shape[0] * mesh.size)


_NS_ITERS = 40


def _psd_sqrt_and_inv(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric PSD square root AND its inverse by coupled Newton-Schulz
    (40 iterations), for one (C, C) matrix or a batch (..., C, C):

        Y_0 = A/a,  Z_0 = I,  T = (3 I - Z Y) / 2,  Y <- Y T,  Z <- T Z,
        sqrt(A) = Y sqrt(a),  sqrt(A)^-1 = Z / sqrt(a),  a = ||A||_F.
    """
    c = cov.shape[-1]
    eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
    alpha = torch.sqrt(torch.sum(cov * cov, dim=(-2, -1), keepdim=True))
    y = cov / alpha
    z = eye.expand_as(cov)
    for _ in range(_NS_ITERS):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    sa = torch.sqrt(alpha)
    return y * sa, z / sa


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    # cholesky_ex: no host sync to check the factorisation (the JAX
    # package's cholesky does not check either; a failure shows as NaNs)
    return torch.linalg.cholesky_ex(a)[0]


def _ridge(cov: torch.Tensor, eps: float) -> torch.Tensor:
    c = cov.shape[-1]
    return cov + eps * torch.eye(c, dtype=cov.dtype, device=cov.device)


def moment_transform(cov_t: torch.Tensor, cov_s: torch.Tensor, mode: str,
                     eps: float = 1.0) -> torch.Tensor:
    """C x C matrix A with matched = centered_target @ A^T + mu_source.
    chol: L_s L_t^{-1} | pca: Q_s Q_t^{-1} | sym: Q_t^{-1} (Q_t C_s Q_t)^{1/2} Q_t^{-1}."""
    ct, cs = _ridge(cov_t, eps), _ridge(cov_s, eps)
    if mode == "chol":
        return torch.linalg.solve_triangular(_cholesky(ct), _cholesky(cs),
                                             upper=False, left=False)
    if mode == "pca":
        _, qt_inv = _psd_sqrt_and_inv(ct)
        qs, _ = _psd_sqrt_and_inv(cs)
        return qs @ qt_inv
    if mode == "sym":
        qt, qt_inv = _psd_sqrt_and_inv(ct)
        msqrt, _ = _psd_sqrt_and_inv(qt @ cs @ qt)
        return qt_inv @ msqrt @ qt_inv
    raise ValueError(f"unknown moment mode {mode!r}")


def style_congruence_batch(rotations: torch.Tensor,
                           cov_s_raw: torch.Tensor) -> torch.Tensor:
    """R_i^T Cov_s R_i for a whole stage's rotation batch at once."""
    return rotations.transpose(1, 2) @ cov_s_raw @ rotations


def style_factor_batch(cov_s_rots: torch.Tensor, mode: str,
                       eps: float = 1.0) -> torch.Tensor:
    """The style-side decomposition of every iteration, batched: chol ->
    Cholesky factors L_s; pca -> PSD square roots Q_s; sym -> the ridged
    covariance itself."""
    cs = _ridge(cov_s_rots, eps)
    if mode == "chol":
        return _cholesky(cs)
    if mode == "pca":
        return _psd_sqrt_and_inv(cs)[0]
    if mode == "sym":
        return cs
    raise ValueError(f"unknown moment mode {mode!r}")


def moment_transform_pre(cov_t: torch.Tensor, style_factor: torch.Tensor,
                         mode: str, eps: float = 1.0) -> torch.Tensor:
    """:func:`moment_transform` with the style side precomputed by
    :func:`style_factor_batch`."""
    ct = _ridge(cov_t, eps)
    if mode == "chol":
        return torch.linalg.solve_triangular(_cholesky(ct), style_factor,
                                             upper=False, left=False)
    if mode == "pca":
        _, qt_inv = _psd_sqrt_and_inv(ct)
        return style_factor @ qt_inv
    if mode == "sym":
        qt, qt_inv = _psd_sqrt_and_inv(ct)
        msqrt, _ = _psd_sqrt_and_inv(qt @ style_factor @ qt)
        return qt_inv @ msqrt @ qt_inv
    raise ValueError(f"unknown moment mode {mode!r}")



def moment_match(target: torch.Tensor, source: torch.Tensor, mode: str,
                 eps: float = 1.0) -> torch.Tensor:
    """Full moment matching, NHWC -> NHWC."""
    mu_t, cov_t = moment_stats(target)
    mu_s, cov_s = moment_stats(source)
    a = moment_transform(cov_t, cov_s, mode, eps)
    c = target.shape[-1]
    matched = ((target - mu_t).reshape(-1, c) @ a.T).reshape(target.shape)
    return matched + mu_s


# ----------------------------------------------------------------------------
# CDF matching (exact 1-D OT on 256 shared-range bins)

BINS = cdf.BINS


def interp_ref(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """The reference's custom 1-D interp: idx = the first position with
    xp[idx] >= x (searchsorted, left), a linear map on [idx, idx+1], falling
    back to anchoring at xp[idx+1] and then to fp[idx] where non-finite
    (duplicate xp nodes)."""
    n = xp.shape[0]
    idxs = torch.searchsorted(xp, x.contiguous()).clamp(0, n - 1)
    idxs_next = (idxs + 1).clamp(0, n - 1)
    xp_i, xp_n = xp[idxs], xp[idxs_next]
    fp_i, fp_n = fp[idxs], fp[idxs_next]
    slopes = (fp_n - fp_i) / (xp_n - xp_i)
    f0 = slopes * (x - xp_i) + fp_i
    f1 = slopes * (x - xp_n) + fp_n
    return torch.where(torch.isfinite(f0), f0,
                       torch.where(torch.isfinite(f1), f1, fp_i))


def _edges_rows(lo: torch.Tensor, hi: torch.Tensor, bins: int) -> torch.Tensor:
    """(...,) ranges -> (..., bins) right bin edges with jnp.linspace's
    arithmetic as XLA evaluates it in f32: ``fma(hi, s, lo * (1 - s))`` with
    s = i / bins (the fused multiply-add taken exactly in f64), the last
    edge exactly hi."""
    s = torch.arange(1, bins + 1, dtype=lo.dtype, device=lo.device) / bins
    low = lo[..., None] * (1 - s)
    edges = (low.double() + hi[..., None].double() * s.double()).to(lo.dtype)
    edges[..., -1] = hi
    return edges


def _histc(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
           bins: int) -> torch.Tensor:
    """torch.histc semantics on one channel (the legacy oracle)."""
    return cdf.histogram_plain(x[None], lo[None], hi[None], bins)[0]


def _cdf_apply_channel(t, t_hist, s_hist, lo, hi, bins):
    """Apply CDF matching to one channel given its histograms (legacy)."""
    edges = _edges_rows(lo, hi, bins)
    t_cdf = torch.cumsum(t_hist, 0)
    t_cdf = t_cdf / t_cdf[-1]
    s_cdf = torch.cumsum(s_hist, 0)
    s_cdf = s_cdf / s_cdf[-1]
    remapped = interp_ref(t_cdf, s_cdf, edges)
    return interp_ref(t, edges, remapped)


def _cdf_match_channel(t: torch.Tensor, s: torch.Tensor, bins: int) -> torch.Tensor:
    """One channel: shared-range histograms -> CDFs -> double remap (the
    legacy searchsorted path, the oracle for ``bins != 256``)."""
    lo = torch.minimum(t.min(), s.min())
    hi = torch.maximum(t.max(), s.max())
    return _cdf_apply_channel(t, _histc(t, lo, hi, bins), _histc(s, lo, hi, bins),
                              lo, hi, bins)


def _remap_table_rows(t_cdf: torch.Tensor, s_cdf: torch.Tensor,
                      edges: torch.Tensor) -> torch.Tensor:
    """remapped[c] = interp_ref(t_cdf[c]; xp=s_cdf[c], fp=edges[c]) for every
    channel at once (:func:`.cdf.interp_rows`: a batched searchsorted, which
    on the non-decreasing s_cdf rows is the JAX package's compare-count
    #(s_cdf < t_cdf) without its (C, B, B) compare, and gathers)."""
    return cdf.interp_rows(t_cdf, s_cdf, edges)


def cdf_cdfs_rows(t_hist: torch.Tensor, s_hist: torch.Tensor):
    """Histogram counts -> normalized CDFs (reference op order)."""
    t_cdf = torch.cumsum(t_hist, dim=1)
    t_cdf = t_cdf / t_cdf[:, -1:]
    s_cdf = torch.cumsum(s_hist, dim=1)
    s_cdf = s_cdf / s_cdf[:, -1:]
    return t_cdf, s_cdf


def _on_kernels(use_pallas: bool, bins: int, device) -> bool:
    """Whether a cdf call goes through the wrappers of :mod:`.cdf`.
    ``use_pallas=False`` (or ``bins != 256``) selects the plain
    formulation, a CPU reference: on a GPU it raises, so a CUDA tensor
    never runs a plain version silently."""
    on_cpu = torch.device(device).type == "cpu"
    if use_pallas and bins == BINS:
        return True
    if not on_cpu:
        raise ValueError("the cdf path on a GPU runs on the CUDA kernels "
                         "(use_pallas=True, 256 bins); use_pallas=False and "
                         "other bin counts are CPU references")
    return False


def histogram_rows(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   bins: int = BINS, use_pallas: bool = True) -> torch.Tensor:
    """(C, N) samples + per-channel ranges -> (C, bins) float32 counts with
    torch.histc binning (the batched_histogram kernel on a GPU)."""
    if _on_kernels(use_pallas, bins, x.device):
        return cdf.batched_histogram(x, lo, hi)
    return cdf.histogram_plain(x, lo, hi, bins)


def cdf_apply_rows(t: torch.Tensor, t_hist: torch.Tensor, s_hist: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor,
                   use_pallas: bool = True) -> torch.Tensor:
    """Apply cdf matching to (C, N) target rows given per-channel histograms
    on the shared range: the table work (cdfs, cdf -> cdf remap) in plain
    PyTorch, the per-sample PWL map on the pwl_remap kernel on a GPU."""
    bins = t_hist.shape[1]
    t_cdf, s_cdf = cdf_cdfs_rows(t_hist, s_hist)
    remapped = _remap_table_rows(t_cdf, s_cdf, _edges_rows(lo, hi, bins))
    if _on_kernels(use_pallas, bins, t.device):
        return cdf.pwl_remap(t, remapped, lo, hi)
    return cdf.pwl_remap_plain(t, remapped, lo, hi)


def cdf_match_rows(t: torch.Tensor, s: torch.Tensor, bins: int = BINS,
                   use_pallas: bool = True, mesh=None) -> torch.Tensor:
    """Row-major cdf matching core: t (C, Nt) matched to s (C, Ns).

    With a ``mesh`` ``t`` is this rank's shard of the target cloud and ``s``
    the (replicated) source: the range is the global one (one MIN reduction
    of the local target extremes, the maxima negated, then combined with the
    source's) and the target counts are summed over the ranks (exact: integer
    counts in float32), so every rank maps its samples by the global cdf.
    The source's counts are this rank's own, which every rank has."""
    t_lo, t_hi = torch.aminmax(t, dim=1)
    if mesh is not None:
        ext = mesh.pmin(torch.cat([t_lo, -t_hi]))
        t_lo, t_hi = ext[:t.shape[0]], -ext[t.shape[0]:]
    s_lo, s_hi = torch.aminmax(s, dim=1)
    lo, hi = torch.minimum(t_lo, s_lo), torch.maximum(t_hi, s_hi)
    if _on_kernels(use_pallas, bins, t.device):
        t_hist, s_hist = cdf.histogram_pair(t, s, lo, hi)   # one launch
    else:
        t_hist = cdf.histogram_plain(t, lo, hi, bins)
        s_hist = cdf.histogram_plain(s, lo, hi, bins)
    if mesh is not None:
        t_hist = mesh.psum(t_hist)
    return cdf_apply_rows(t, t_hist, s_hist, lo, hi, use_pallas)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous (C, N) rows (the kernels' layout; one copy)."""
    return x.reshape(-1, x.shape[-1]).T.contiguous()


def cdf_match(target: torch.Tensor, source: torch.Tensor, bins: int = BINS,
              use_pallas: bool = True) -> torch.Tensor:
    """CDF matching, NHWC -> NHWC, all channels at once. ``bins != 256``
    runs the legacy per-channel searchsorted path (the oracle)."""
    t, s = _rows(target), _rows(source)
    if bins != BINS:
        matched = torch.stack([_cdf_match_channel(tc, sc, bins)
                               for tc, sc in zip(t, s)])
    else:
        matched = cdf_match_rows(t, s, bins, use_pallas)
    return matched.T.reshape(target.shape)


# ----------------------------------------------------------------------------
# Sort matching: exact sliced 1-D optimal transport


def sort_match(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Exact per-channel 1-D OT via order statistics, NHWC -> NHWC: the
    r-th smallest target sample takes the source's (r + 0.5)/Nt quantile."""
    return sort_match_rows(_rows(target), _rows(source)).T.reshape(target.shape)


# Above this many elements in the larger of the two (C, N) clouds the
# per-channel sorts run in channel blocks, bounding the live sort buffers
# (the JAX package's default threshold; tests may pin another value)
_SORT_BLOCK_ELEMS = 192 * 1024 * 1024


def sort_match_rows(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Row-major core of :func:`sort_match`: t (C, Nt) matched to s (C, Ns)
    per row, in t's original sample order. Clouds past the block threshold
    process blocks of ``cap // max(Nt, Ns)`` channels in turn (rows are
    independent, so the result is the same)."""
    c, nt = t.shape
    m = max(nt, s.shape[1], 1)
    if c > 1 and c * m > _SORT_BLOCK_ELEMS:
        rows = max(1, _SORT_BLOCK_ELEMS // m)
        return torch.cat([_sort_match_rows_impl(t[i:i + rows], s[i:i + rows])
                          for i in range(0, c, rows)])
    return _sort_match_rows_impl(t, s)


def _sort_match_rows_impl(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    nt, ns = t.shape[1], s.shape[1]
    s_sorted = torch.sort(s, dim=1).values
    order = torch.sort(t, dim=1, stable=True).indices
    src_idx = np.clip(((np.arange(nt) + 0.5) * (ns / nt)).astype(np.int64),
                      0, ns - 1)
    matched_sorted = s_sorted[:, torch.from_numpy(src_idx).to(s.device)]
    # the inverse permutation: the r-th smallest goes back to its position
    return torch.empty_like(t).scatter_(1, order, matched_sorted)


# ----------------------------------------------------------------------------
# Unified entry, reference signature


def hist_match(target: torch.Tensor, source: torch.Tensor, mode: str = "chol",
               eps: float = 1.0, use_pallas: bool = True) -> torch.Tensor:
    """NHWC target matched to NHWC source's per-channel statistics."""
    if mode == "cdf":
        return cdf_match(target, source, use_pallas=use_pallas)
    if mode == "sort":
        return sort_match(target, source)
    return moment_match(target, source, mode, eps)
