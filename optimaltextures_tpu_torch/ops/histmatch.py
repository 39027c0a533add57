"""Moment matching (chol / pca / sym) — the moment half of
``optimaltextures_tpu/ops/histmatch.py``.

First/second-moment matching through the C x C channel covariance with the
reference's eps=1 ridge. Everything stays (..., C) sample-major so the big
contractions are (N, C) GEMMs. Centering is per (batch element, channel);
the covariance pools all samples. The cdf/sort half is not ported yet
(ROADMAP.md, queue 1 item 10).

Matmuls run in full float32: the port turns TF32 off on its f32 path
(``core.full_f32_precision``), the counterpart of the JAX package's
``precision=HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def moment_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) -> mu (B, 1, 1, C), pooled raw covariance (C, C)."""
    c = x.shape[-1]
    mu = x.mean(dim=(1, 2), keepdim=True)
    xc = (x - mu).reshape(-1, c)
    return mu, (xc.T @ xc) / xc.shape[0]


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

