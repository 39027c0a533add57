"""Haar-random SO(n) sampling by Newton-Schulz polar iteration (the
counterpart of ``optimaltextures_tpu/ops/rotation.py``).

The orthogonal polar factor of a Ginibre (iid normal) matrix is Haar on O(n);
X <- 1.5 X - 0.5 X X^T X converges to it with batched matmuls only, and
flipping the last column where det(G) < 0 lands on SO(n).

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


def polar_rotations(g: torch.Tensor) -> torch.Tensor:
    """(n_rot, n, n) Gaussian -> its (n_rot, n, n) SO(n) polar factors."""
    norm = torch.sqrt(torch.sum(g * g, dim=(1, 2), keepdim=True))
    x = g / norm
    for _ in range(_POLAR_ITERS):
        xtx = torch.matmul(x, x.transpose(1, 2))
        x = 1.5 * x - 0.5 * torch.matmul(xtx, x)
    sign, _ = torch.linalg.slogdet(g)   # det(Q) sign == det(G) sign (P is PSD)
    x = x.clone()
    x[:, :, -1] *= sign[:, None]
    return x


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
