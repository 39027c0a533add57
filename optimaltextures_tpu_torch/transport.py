"""Sliced optimal transport, plus PCA fitting (the counterpart of
``optimaltextures_tpu/transport.py``).

Moment modes (chol / pca / sym): every iteration is affine in the samples,
``f -> (f - mu_i) @ m_i + mu_s``, and ``m_i`` depends on the current cloud
only through its mean and covariance, which propagate in closed form (as
does the content pull ``f -> f + s*(cf - f)``). So a whole stage's
iterations compose into ONE affine map built by a C x C loop
(:func:`compose_moment_chain`), and the (B*H*W, C) features are touched by a
single GEMM (two with a content pull). ``cov_propagation=False`` (or
``OPTEX_NO_COV_PROP=1``) runs the iterations one by one instead, each
recomputing the cloud's moments from the data
(:func:`_moment_step_with_factor`), with the style side of every iteration
batched out of the loop.

Sampled modes (cdf / sort): each iteration rotates the pastiche and style
clouds, matches every rotated coordinate (cdf on the CUDA kernels of
``ops/cdf.py``), rotates back and applies the content pull.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import config
from .ops import histmatch
from .ops.rotation import (random_rotation, stage_rotations,
                           stage_rotations_masked)


def cov_propagation_enabled() -> bool:
    """False when OPTEX_NO_COV_PROP=1 (read at call time,
    config.cov_propagation_env_off): the moment modes then run the
    per-iteration loop, whatever ``OptexConfig.cov_propagation`` says."""
    return not config.cov_propagation_env_off()


class StyleStats(NamedTuple):
    """Per-(pass, layer) style statistics: ``mu`` (1, 1, 1, C) and the raw
    covariance ``cov_raw`` (C, C, no ridge) for the moment modes; the
    sample cloud ``samples`` (Ns, C) for cdf/sort (None otherwise)."""
    mu: torch.Tensor
    cov_raw: torch.Tensor
    samples: Optional[torch.Tensor] = None


def style_stats(style_feature: torch.Tensor,
                need_samples: bool = False) -> StyleStats:
    """NHWC style features -> transport statistics."""
    mu, cov = histmatch.moment_stats(style_feature)
    samples = (style_feature.reshape(-1, style_feature.shape[-1])
               if need_samples else None)
    return StyleStats(mu=mu, cov_raw=cov, samples=samples)


def _moment_step_with_rot(rot: torch.Tensor, feature: torch.Tensor,
                          stats: StyleStats, mode: str,
                          eps: float = 1.0, mesh=None,
                          mean_mesh=None) -> torch.Tensor:
    """One moment-matching sliced-OT step with a supplied rotation:
    ``(x - mu_t) @ (R A^T R^T) + mu_s``, A computed in the rotated basis
    from the congruence-rotated covariances (pooled over the ranks of a
    ``mesh``, the means over a ``mean_mesh``: histmatch.moment_stats)."""
    c = feature.shape[-1]
    mu_t, cov_t_raw = histmatch.moment_stats(feature, mesh, mean_mesh)
    a = histmatch.moment_transform(rot.T @ (cov_t_raw @ rot),
                                   rot.T @ (stats.cov_raw @ rot), mode, eps)
    m = rot @ (a.T @ rot.T)
    out = ((feature - mu_t).reshape(-1, c) @ m).reshape(feature.shape)
    return out + stats.mu


def _moment_step_with_factor(rot: torch.Tensor, feature: torch.Tensor,
                             mu_s: torch.Tensor, sfactor: torch.Tensor,
                             mode: str, eps: float = 1.0,
                             mesh=None, mean_mesh=None) -> torch.Tensor:
    """:func:`_moment_step_with_rot` with the style side precomputed
    (histmatch.style_factor_batch): the per-iteration loop's body. With a
    ``mesh`` the covariance pools every rank's shard (the means over a
    ``mean_mesh``)."""
    c = feature.shape[-1]
    mu_t, cov_t_raw = histmatch.moment_stats(feature, mesh, mean_mesh)
    a = histmatch.moment_transform_pre(rot.T @ (cov_t_raw @ rot), sfactor,
                                       mode, eps)
    m = rot @ (a.T @ rot.T)
    out = ((feature - mu_t).reshape(-1, c) @ m).reshape(feature.shape)
    return out + mu_s


def ot_step_moment(gen: Optional[torch.Generator], feature: torch.Tensor,
                   stats: StyleStats, mode: str, eps: float = 1.0,
                   rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One moment-mode sliced-OT iteration; the rotation is drawn from
    ``gen`` (QR) unless ``rotation`` is given."""
    if rotation is None:
        rotation = random_rotation(gen, feature.shape[-1], feature.device)
    return _moment_step_with_rot(rotation.to(feature), feature, stats, mode,
                                 eps)


def _sampled_step_with_rot(rot: torch.Tensor, feature: torch.Tensor,
                           style_samples: torch.Tensor, mode: str,
                           use_pallas: bool = True,
                           mesh=None) -> torch.Tensor:
    """One cdf/sort sliced-OT step with a supplied rotation. The rotated
    clouds come out of their GEMMs directly as the (C, N) rows the matchers
    take (``R^T X^T``), and the matched rows go back through one more GEMM,
    so no transposed copy of the samples is made.

    With a ``mesh`` ``feature`` is this rank's shard: cdf matches by the
    global histogram (histmatch.cdf_match_rows), and sort gathers every
    rank's rotated samples in rank order, which is the single-device flatten
    order (rank r holds batch rows r*B/N .., or under spatial sharding row
    block r of the one image), matches the whole cloud exactly and keeps its
    own columns. On the 2-D grid (a parallel.mesh.GridMesh) sort takes the
    grid's two-step gather (parallel.shard_ot._sort_step_grid)."""
    if mode == "sort" and mesh is not None and mesh.grid:
        from .parallel.shard_ot import _sort_step_grid

        return _sort_step_grid(rot, feature, style_samples, mesh)
    c = feature.shape[-1]
    rf = rot.T @ feature.reshape(-1, c).T          # (C, N) rows
    rs = rot.T @ style_samples.T
    if mode == "sort" and mesh is not None:
        n = rf.shape[1]
        matched = histmatch.sort_match_rows(mesh.all_gather(rf, dim=1), rs)
        matched = matched[:, mesh.rank * n:(mesh.rank + 1) * n]
    elif mode == "sort":
        matched = histmatch.sort_match_rows(rf, rs)
    else:
        matched = histmatch.cdf_match_rows(rf, rs, use_pallas=use_pallas,
                                           mesh=mesh)
    return (matched.T @ rot.T).reshape(feature.shape)


def ot_step_sampled(gen: Optional[torch.Generator], feature: torch.Tensor,
                    style_samples: torch.Tensor, mode: str,
                    use_pallas: bool = True,
                    rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sliced-OT iteration on raw sample clouds: cdf (256-bin, reference
    semantics) or sort (exact 1-D OT). The rotation is drawn from ``gen``
    (QR) unless ``rotation`` is given."""
    if rotation is None:
        rotation = random_rotation(gen, feature.shape[-1], feature.device)
    return _sampled_step_with_rot(rotation.to(feature), feature, style_samples,
                                  mode, use_pallas)


def ot_step_cdf(gen, feature, style_samples, use_pallas: bool = True,
                rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cdf sliced-OT iteration (the color tail's pixel-space step)."""
    return ot_step_sampled(gen, feature, style_samples, "cdf", use_pallas,
                           rotation)


def ot_step_reference(gen: Optional[torch.Generator], feature: torch.Tensor,
                      style_feature: torch.Tensor, mode: str, eps: float = 1.0,
                      use_pallas: bool = True,
                      rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Faithful rotate/match/unrotate on raw NHWC features, any mode."""
    if rotation is None:
        rotation = random_rotation(gen, feature.shape[-1], feature.device)
    rot = rotation.to(feature)
    matched = histmatch.hist_match(feature @ rot, style_feature @ rot, mode,
                                   eps, use_pallas)
    return matched @ rot.T


def pca_spectrum(features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Singular values (descending) and right singular vectors of the
    scalar-mean-centered sample matrix, via eigh of the C x C Gram matrix.
    Eigenvector signs are the solver's; only the spectrum and the projector
    are basis-independent."""
    c = features.shape[-1]
    x = features.reshape(-1, c) - features.mean()
    eva, eve = torch.linalg.eigh(x.T @ x)        # ascending
    s = torch.sqrt(torch.clamp(eva.flip(0), min=0.0))
    return s, eve.flip(1)


def choose_k(singular_values) -> int:
    """Host-side: the reference's component count — the FIRST index where
    cumsum(s / sum(s)) > 0.9 (exclusive of the crossing component), clamped
    to >= 1."""
    if isinstance(singular_values, torch.Tensor):
        singular_values = singular_values.detach().cpu().numpy()
    s = np.asarray(singular_values, dtype=np.float64)
    frac = np.cumsum(s / s.sum())
    return max(int(np.argmax(frac > 0.9)), 1)


def compose_moment_chain(rotations: torch.Tensor, sfactors: torch.Tensor,
                         mu0: torch.Tensor, cov0: torch.Tensor,
                         mu_s: torch.Tensor, mode: str, eps: float,
                         content_strength: float = 0.0,
                         cross0: Optional[torch.Tensor] = None,
                         content_cov: Optional[torch.Tensor] = None,
                         content_mu: Optional[torch.Tensor] = None):
    """Fold a stage's moment-mode OT iterations (+ the optional content pull)
    into ``out = feat0 @ A (+ content @ Bc) + bias``: per iteration i, with
    the propagated moments (mu, cov) and the cross-covariance X = Cov(f, cf),

        m_i  = R_i A_i^T R_i^T,  A_i = moment_transform_pre(R_i^T cov R_i)
        A   <- A m_i,  Bc <- Bc m_i,  bias <- bias m_i + mu_s - mu m_i,
        mu  <- mu_s,   cov  <- m_i^T cov m_i,  X <- m_i^T X,

    then the pull f -> (1-s) f + s cf:

        A <- (1-s) A,  Bc <- (1-s) Bc + s I,  bias <- (1-s) bias,
        mu <- (1-s) mu + s mu_cf,  X <- (1-s) X + s cov_cf,
        cov <- (1-s)^2 cov + (1-s) s (X' + X'^T) + s^2 cov_cf  (X' before
        the pull).

    Returns (A (C, C), Bc (C, C) or None without content, bias (B, 1, 1, C))."""
    c = cov0.shape[-1]
    s = float(content_strength)
    has_content = cross0 is not None and s != 0.0
    eye = torch.eye(c, dtype=cov0.dtype, device=cov0.device)
    A = eye
    Bc = torch.zeros_like(cov0) if has_content else None
    bias = torch.zeros_like(mu0)
    mu, cov, X = mu0, cov0, cross0
    for rot, sfac in zip(rotations, sfactors):
        a = histmatch.moment_transform_pre(rot.T @ (cov @ rot), sfac, mode, eps)
        m = rot @ (a.T @ rot.T)
        A = A @ m
        bias = bias @ m + (mu_s - mu @ m)
        mu = torch.zeros_like(mu0) + mu_s
        cov = m.T @ (cov @ m)
        if not has_content:
            continue
        X = m.T @ X
        Bc = Bc @ m
        A = (1.0 - s) * A
        Bc = (1.0 - s) * Bc + s * eye
        bias = (1.0 - s) * bias
        mu = (1.0 - s) * mu + s * content_mu
        cov = ((1.0 - s) ** 2 * cov + (1.0 - s) * s * (X + X.T)
               + s ** 2 * content_cov)
        X = (1.0 - s) * X + s * content_cov
    return A, Bc, bias


def draw_stage_rotations(gen: torch.Generator, n_iters: int, n: int,
                         device, k_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """A stage's rotation stack from ``gen``: blockdiag(SO(k), I) rotations
    when the features are zero-padded beyond the true rank ``k_mask``, else
    full SO(n) ones. Both draw the same Gaussian."""
    if k_mask is not None:
        return stage_rotations_masked(gen, n_iters, n, k_mask, device)
    return stage_rotations(gen, n_iters, n, device)


def stage_affine_map(rotations: torch.Tensor, mu0: torch.Tensor,
                     cov0: torch.Tensor, stats: StyleStats, mode: str,
                     eps: float = 1.0):
    """The stage's composed affine map from the initial feature moments."""
    cov_s_rots = histmatch.style_congruence_batch(rotations, stats.cov_raw)
    sfactors = histmatch.style_factor_batch(cov_s_rots, mode, eps)
    A, _, bias = compose_moment_chain(rotations, sfactors, mu0, cov0, stats.mu,
                                      mode, eps)
    return A, bias


def transport_loop(gen: Optional[torch.Generator], feature: torch.Tensor,
                   stats: StyleStats, n_iters: int, mode: str,
                   content_feature: Optional[torch.Tensor] = None,
                   content_strength: float = 0.0, eps: float = 1.0,
                   rotations: Optional[torch.Tensor] = None,
                   use_pallas: bool = True,
                   k_mask: Optional[torch.Tensor] = None,
                   cov_prop: Optional[bool] = None,
                   mesh=None, mean_mesh=None) -> torch.Tensor:
    """``n_iters`` sliced-OT steps on NHWC ``feature``, each followed by the
    reference's content pull ``feat += s * (content - feat)`` when a
    content feature is given.

    Moment modes compose the stage into one affine map (with or without
    the pull) unless ``cov_prop`` is False (None = on) or OPTEX_NO_COV_PROP
    is set: then each iteration recomputes the cloud's moments
    (:func:`_moment_step_with_factor`); cdf/sort iterate. Rotations come
    from :func:`draw_stage_rotations` (blockdiag(SO(k), I) with ``k_mask``,
    the traced true rank of zero-padded features) unless ``rotations``
    (n_iters, C, C) is given — the injection hook the parity tests use to
    feed the JAX package's rotation stacks.

    ``mesh`` (parallel.mesh.Mesh): ``feature`` (and ``content_feature``) is
    this rank's shard, and the loop is the JAX package's
    ``sharded_transport_loop_axes`` with ``mesh`` as its Gram axes and
    ``mean_mesh`` as its mean axes: the Gram matrices and sample counts (the
    covariance, the content cross-covariance) are summed over ``mesh``, the
    per-image means over ``mean_mesh`` (None: local to the shard, the
    batch-data-parallel loop; the space mesh under spatial sharding and on
    the grid), cdf takes the global range and target histogram, and sort
    matches the gathered cloud. Every rank draws the same rotations, so
    every rank builds the same maps."""
    if n_iters == 0:
        return feature
    if mode not in ("chol", "pca", "sym", "cdf", "sort"):
        raise ValueError(f"unknown hist_mode {mode!r}")
    c = feature.shape[-1]
    if rotations is None:
        rotations = draw_stage_rotations(gen, n_iters, c, feature.device,
                                         k_mask)
    if tuple(rotations.shape) != (n_iters, c, c):
        raise ValueError(f"rotations {tuple(rotations.shape)} != "
                         f"{(n_iters, c, c)}")
    rotations = rotations.to(device=feature.device, dtype=torch.float32)

    if mode in ("cdf", "sort"):
        for rot in rotations:
            feature = _sampled_step_with_rot(rot, feature, stats.samples, mode,
                                             use_pallas, mesh)
            if content_feature is not None:
                feature = feature + content_strength * (content_feature - feature)
        return feature

    if cov_prop is False or not cov_propagation_enabled():
        # the per-iteration loop: the style side of every iteration
        # (congruences and decompositions) is batched out of it
        sfactors = histmatch.style_factor_batch(
            histmatch.style_congruence_batch(rotations, stats.cov_raw), mode,
            eps)
        for rot, sfac in zip(rotations, sfactors):
            feature = _moment_step_with_factor(rot, feature, stats.mu, sfac,
                                               mode, eps, mesh, mean_mesh)
            if content_feature is not None:
                feature = feature + content_strength * (content_feature - feature)
        return feature

    mu0, cov0 = histmatch.moment_stats(feature, mesh, mean_mesh)
    if content_feature is None or content_strength == 0.0:
        A, bias = stage_affine_map(rotations, mu0, cov0, stats, mode, eps)
        out = (feature.reshape(-1, c) @ A).reshape(feature.shape)
        return out + bias
    # composed with the content pull
    cov_s_rots = histmatch.style_congruence_batch(rotations, stats.cov_raw)
    sfactors = histmatch.style_factor_batch(cov_s_rots, mode, eps)
    mu_cf, cov_cf = histmatch.moment_stats(content_feature, mesh, mean_mesh)
    content_feature = content_feature.expand(feature.shape)
    fc = (feature - mu0).reshape(-1, c)
    cc = (content_feature - mu_cf).reshape(-1, c)
    if mesh is None:
        cross0 = (fc.T @ cc) / fc.shape[0]
    else:
        cross0 = mesh.psum(fc.T @ cc) / (fc.shape[0] * mesh.size)
    A, Bc, bias = compose_moment_chain(rotations, sfactors, mu0, cov0, stats.mu,
                                       mode, eps, content_strength, cross0,
                                       cov_cf, mu_cf)
    out = feature.reshape(-1, c) @ A + content_feature.reshape(-1, c) @ Bc
    return out.reshape(feature.shape) + bias
