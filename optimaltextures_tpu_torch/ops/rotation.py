"""Haar-random SO(n) sampling (the counterpart of
``optimaltextures_tpu/ops/rotation.py``).

Stages draw their rotation stacks by Newton-Schulz polar iteration: the
orthogonal polar factor of a Ginibre (iid normal) matrix is Haar on O(n);
X <- 1.5 X - 0.5 X X^T X converges to it with batched matmuls only, and
flipping the last column where det(G) < 0 lands on SO(n). The pixel-space
color steps draw single 3x3 rotations by QR (:func:`random_rotation`).

Random streams: the JAX package draws its Gaussians from threefry keys, the
port from ``torch.Generator``s, so the two never draw the same numbers. The
parity tests therefore feed the same Gaussian to :func:`polar_rotations`, or
inject whole rotation stacks through ``transport.transport_loop(...,
rotations=...)`` / ``core.Synthesizer.run(..., rotations=...)``.
"""

from __future__ import annotations

import numpy as np
import torch

_POLAR_ITERS = 30


def _polar_factor(g: torch.Tensor) -> torch.Tensor:
    """(n_rot, n, n) -> the orthogonal polar factors, O(n), by
    ``_POLAR_ITERS`` Newton-Schulz steps from the Frobenius-scaled matrix."""
    norm = torch.sqrt(torch.sum(g * g, dim=(1, 2), keepdim=True))
    x = g / norm
    for _ in range(_POLAR_ITERS):
        xtx = torch.matmul(x, x.transpose(1, 2))
        x = 1.5 * x - 0.5 * torch.matmul(xtx, x)
    return x


def polar_rotations(g: torch.Tensor) -> torch.Tensor:
    """(n_rot, n, n) Gaussian -> its (n_rot, n, n) SO(n) polar factors."""
    x = _polar_factor(g)
    sign, _ = torch.linalg.slogdet(g)   # det(Q) sign == det(G) sign (P is PSD)
    x = x.clone()
    x[:, :, -1] *= sign[:, None]
    return x


def random_rotation(gen: torch.Generator, n: int, device="cpu") -> torch.Tensor:
    """One Haar-random (n, n) SO(n) matrix drawn from ``gen`` (QR path: QR
    of a Gaussian, the R-diagonal sign fix, then the last column flipped
    where det = -1). The pixel-space color steps draw from it."""
    g = torch.randn((n, n), generator=gen, device=device, dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    q = q * torch.where(torch.diagonal(r) >= 0, 1.0, -1.0)[None, :]
    sign, _ = torch.linalg.slogdet(q)
    q = q.clone()
    q[:, -1] *= sign
    return q


def random_rotations_polar(gen: torch.Generator, n_rot: int, n: int,
                           device="cpu") -> torch.Tensor:
    """(n_rot, n, n) Haar-random SO(n) matrices drawn from ``gen`` (a
    generator on ``device``)."""
    g = torch.randn((n_rot, n, n), generator=gen, device=device,
                    dtype=torch.float32)
    return polar_rotations(g)


def stage_rotations(gen: torch.Generator, n_iters: int, n: int,
                    device="cpu") -> torch.Tensor:
    """The (n_iters, n, n) rotation stack of one OT stage."""
    return random_rotations_polar(gen, n_iters, n, device)


def masked_polar_rotations(g: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(n_rot, n, n) Gaussian and a 0-d int tensor ``k`` -> the SO(n)
    rotations blockdiag(polar(G_k), I_{n-k}), with ``k`` kept on the device.

    Masking the Gaussian to blockdiag(G_k, I) before the Newton-Schulz
    iteration gives exactly that: the iteration keeps the block structure,
    the polar factor is scale-invariant and the identity block passes
    through. The det fix flips column k-1, the last column inside the active
    block (flipping a pad column would break the identity block), so
    features zero-padded beyond k stay exactly zero under the rotations."""
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device)
    k = torch.as_tensor(k, device=g.device)
    inside = (idx[:, None] < k) & (idx[None, :] < k)
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    g = torch.where(inside, g, eye)
    sign, _ = torch.linalg.slogdet(g)
    flip = (idx == k - 1)[None, None, :]
    return _polar_factor(g) * torch.where(flip, sign[:, None, None], 1.0)


def stage_rotations_masked(gen: torch.Generator, n_iters: int, n: int,
                           k: torch.Tensor, device="cpu") -> torch.Tensor:
    """The (n_iters, n, n) rotation stack of a stage whose features are
    zero-padded beyond the true PCA rank ``k`` (pca_bucket, pca_traced_k):
    the same Gaussian draw as :func:`stage_rotations`, masked to
    blockdiag(SO(k), I) (:func:`masked_polar_rotations`)."""
    g = torch.randn((n_iters, n, n), generator=gen, device=device,
                    dtype=torch.float32)
    return masked_polar_rotations(g, k)


def derive_seed(*parts: int) -> int:
    """A 63-bit seed from integer parts (a run key, a pass index, a stage
    index, ...): the port's counterpart of ``jax.random.fold_in`` chains."""
    ss = np.random.SeedSequence([int(p) % (2 ** 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, *parts: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``derive_seed(*parts)``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(*parts))
    return g
