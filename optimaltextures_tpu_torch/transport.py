"""Sliced optimal transport for the moment modes, plus PCA fitting (the
counterpart of ``optimaltextures_tpu/transport.py``).

Every moment-mode iteration is affine in the samples, ``f -> (f - mu_i) @
m_i + mu_s``, and ``m_i`` depends on the current cloud only through its mean
and covariance, which propagate in closed form. So a whole stage's
iterations compose into ONE affine map built by a C x C loop
(:func:`compose_moment_chain`), and the (B*H*W, C) features are touched by a
single GEMM. This port has that composed branch only (cov_propagation on,
no content pull); the iterative and content branches are ROADMAP items.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ops import histmatch
from .ops.rotation import stage_rotations


class StyleStats(NamedTuple):
    """Per-(pass, layer) style statistics for the moment modes: ``mu``
    (1, 1, 1, C) and the raw covariance ``cov_raw`` (C, C, no ridge)."""
    mu: torch.Tensor
    cov_raw: torch.Tensor


def style_stats(style_feature: torch.Tensor) -> StyleStats:
    """NHWC style features -> transport statistics."""
    mu, cov = histmatch.moment_stats(style_feature)
    return StyleStats(mu=mu, cov_raw=cov)


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
                         mu_s: torch.Tensor, mode: str, eps: float):
    """Fold a stage's moment-mode OT iterations into ``out = feat0 @ A +
    bias``: per iteration i, with the propagated moments (mu, cov),

        m_i  = R_i A_i^T R_i^T,  A_i = moment_transform_pre(R_i^T cov R_i)
        A   <- A m_i,  bias <- bias m_i + mu_s - mu m_i,
        mu  <- mu_s,   cov  <- m_i^T cov m_i.

    Returns (A (C, C), bias (B, 1, 1, C))."""
    c = cov0.shape[-1]
    A = torch.eye(c, dtype=cov0.dtype, device=cov0.device)
    bias = torch.zeros_like(mu0)
    mu, cov = mu0, cov0
    for rot, sfac in zip(rotations, sfactors):
        a = histmatch.moment_transform_pre(rot.T @ (cov @ rot), sfac, mode, eps)
        m = rot @ (a.T @ rot.T)
        A = A @ m
        bias = bias @ m + (mu_s - mu @ m)
        mu = torch.zeros_like(mu0) + mu_s
        cov = m.T @ (cov @ m)
    return A, bias


def stage_affine_map(rotations: torch.Tensor, mu0: torch.Tensor,
                     cov0: torch.Tensor, stats: StyleStats, mode: str,
                     eps: float = 1.0):
    """The stage's composed affine map from the initial feature moments."""
    cov_s_rots = histmatch.style_congruence_batch(rotations, stats.cov_raw)
    sfactors = histmatch.style_factor_batch(cov_s_rots, mode, eps)
    return compose_moment_chain(rotations, sfactors, mu0, cov0, stats.mu,
                                mode, eps)


def transport_loop(gen: Optional[torch.Generator], feature: torch.Tensor,
                   stats: StyleStats, n_iters: int, mode: str,
                   eps: float = 1.0,
                   rotations: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_iters`` sliced-OT steps on NHWC ``feature``, composed.

    Rotations come from ``stage_rotations(gen, ...)`` unless ``rotations``
    (n_iters, C, C) is given — the injection hook the parity tests use to
    feed the JAX package's rotation stacks."""
    if n_iters == 0:
        return feature
    if mode not in ("chol", "pca", "sym"):
        raise NotImplementedError(f"hist_mode {mode!r} is not ported yet "
                                  "(ROADMAP.md, queue 1 item 10)")
    c = feature.shape[-1]
    if rotations is None:
        rotations = stage_rotations(gen, n_iters, c, feature.device)
    if tuple(rotations.shape) != (n_iters, c, c):
        raise ValueError(f"rotations {tuple(rotations.shape)} != "
                         f"{(n_iters, c, c)}")
    rotations = rotations.to(device=feature.device, dtype=torch.float32)
    mu0, cov0 = histmatch.moment_stats(feature)
    A, bias = stage_affine_map(rotations, mu0, cov0, stats, mode, eps)
    out = (feature.reshape(-1, c) @ A).reshape(feature.shape)
    return out + bias
