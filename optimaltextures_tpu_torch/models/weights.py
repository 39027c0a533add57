"""Weight loading: the repo's ``weights/*.npz`` archives into torch tensors.

The archives hold HWIO float32 conv weights (the JAX package's layout,
converted once from the upstream ``.pth`` checkpoints). The port keeps torch's
own OIHW layout, so loading transposes each weight HWIO -> OIHW. Only numpy is
needed to read the archives.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import arch

_DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "weights")

ENCODER_NPZ = "vgg_normalised_conv{d}_1.npz"
DECODER_NPZ = "feature_invertor_conv{d}_1.npz"

# A conv's params as the port holds them: weight (Cout, Cin, kh, kw), bias (Cout,)
ConvParams = Tuple[torch.Tensor, torch.Tensor]
Params = List[ConvParams]


def weights_dir() -> str:
    return os.environ.get("OPTEX_WEIGHTS_DIR", os.path.abspath(_DEFAULT_DIR))


def available_depths(directory: str | None = None) -> List[int]:
    """Depths d for which BOTH the encoder and decoder npz exist."""
    d = directory or weights_dir()
    return [depth for depth in range(1, 6)
            if os.path.exists(os.path.join(d, ENCODER_NPZ.format(d=depth)))
            and os.path.exists(os.path.join(d, DECODER_NPZ.format(d=depth)))]


def _npz_params(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """HWIO numpy params, in archive order."""
    with np.load(path) as z:
        n = int(z["num_convs"])
        return [(z[f"conv{i}_w"].astype(np.float32),
                 z[f"conv{i}_b"].astype(np.float32)) for i in range(n)]


def _check(params, specs, what: str) -> None:
    if len(params) != len(specs):
        raise ValueError(f"{what}: expected {len(specs)} convs, npz has {len(params)}")
    for i, ((w, b), (cin, cout, k, _, _)) in enumerate(zip(params, specs)):
        if tuple(w.shape) != (k, k, cin, cout):
            raise ValueError(f"{what} conv{i}: weight {tuple(w.shape)} != {(k, k, cin, cout)}")
        if tuple(b.shape) != (cout,):
            raise ValueError(f"{what} conv{i}: bias {tuple(b.shape)} != {(cout,)}")


def to_torch(params_hwio: Sequence[Tuple[np.ndarray, np.ndarray]],
             device="cpu") -> Params:
    """HWIO numpy (w, b) pairs -> OIHW float32 torch (w, b) pairs."""
    return [(torch.from_numpy(np.ascontiguousarray(
                 np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(device),
             torch.from_numpy(np.asarray(b, np.float32).copy()).to(device))
            for w, b in params_hwio]


def load_encoder_params(depth: int, directory: str | None = None,
                        device="cpu") -> Params:
    path = os.path.join(directory or weights_dir(), ENCODER_NPZ.format(d=depth))
    params = _npz_params(path)
    _check(params, arch.encoder_specs(depth), f"encoder depth {depth}")
    return to_torch(params, device)


def load_decoder_params(depth: int, directory: str | None = None,
                        device="cpu") -> Params:
    path = os.path.join(directory or weights_dir(), DECODER_NPZ.format(d=depth))
    params = _npz_params(path)
    _check(params, arch.decoder_specs(depth), f"decoder depth {depth}")
    return to_torch(params, device)


def params_from_numpy(enc_params, dec_params, device="cpu"):
    """A JAX bank's parameters -> the port's bank.

    ``enc_params`` / ``dec_params``: ``{depth: [(w_hwio, b), ...]}`` as held
    by ``optimaltextures_tpu``'s ``VGGBank`` or ``synthetic_bank`` (any
    array type numpy can read). Returns a :class:`..models.vgg.VGGBank` with
    identical weights, so both packages compute with the same numbers."""
    from .vgg import VGGBank

    enc = {d: to_torch([(np.asarray(w), np.asarray(b)) for w, b in ps], device)
           for d, ps in enc_params.items()}
    dec = {d: to_torch([(np.asarray(w), np.asarray(b)) for w, b in ps], device)
           for d, ps in dec_params.items()}
    for d in enc:
        _check([(w.permute(2, 3, 1, 0), b) for w, b in enc[d]],
               arch.encoder_specs(d), f"encoder depth {d}")
        _check([(w.permute(2, 3, 1, 0), b) for w, b in dec[d]],
               arch.decoder_specs(d), f"decoder depth {d}")
    return VGGBank.from_params(enc, dec)
