"""NHWC VGG-19 encoder / feature-inverter forward passes.

The counterpart of ``optimaltextures_tpu/models/vgg.py``: plain functions over a
list of OIHW ``(w, b)`` tensors, driven by the spec tables in :mod:`.arch`.
Images enter as (N, H, W, 3) float in [0, 1]; features come out
(N, H/2^{d-1}, W/2^{d-1}, C_d). The convs here are ``F.conv2d`` (the JAX
package leaves them to XLA too); the relu1/relu2-scale convs of the stage
roundtrips run on the CUDA kernels instead, through :mod:`.fastcodec`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.convops import (conv2d_nhwc, maxpool_2x2_ceil, reflect_pad,
                           upsample_nearest_2x)
from . import arch, weights


def _pad(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    if pad_mode != "reflect":
        raise NotImplementedError(
            f"pad mode {pad_mode!r} (tileable output) is not ported to the "
            "torch package yet (ROADMAP.md, queue 1 item 13)")
    return reflect_pad(x, 1)


def _run_stack(params, specs, x: torch.Tensor,
               pad_mode: str = "reflect") -> torch.Tensor:
    for (w, b), (_, _, k, pre, post) in zip(params, specs):
        if pre == "pool":
            x = maxpool_2x2_ceil(x)
        elif pre == "up":
            x = upsample_nearest_2x(x)
        if k == 3:
            x = _pad(x, pad_mode)
        x = conv2d_nhwc(x, w, b)
        if post == "relu":
            x = torch.relu(x)
    return x


def encode(params, depth: int, image: torch.Tensor,
           pad_mode: str = "reflect") -> torch.Tensor:
    """NHWC image -> relu{depth}_1 NHWC features."""
    return _run_stack(params, arch.encoder_specs(depth), image, pad_mode)


def encode_taps(params, depth: int, image: torch.Tensor):
    """NHWC image -> [relu1_1, ..., relu{depth}_1] in one forward pass.
    ``params`` must be the depth-``depth`` encoder parameters."""
    specs = arch.encoder_specs(depth)
    tap_after = {arch._ENCODER_LEN[d] - 1 for d in range(1, depth + 1)}
    taps = []
    x = image
    for i, ((w, b), (_, _, k, pre, post)) in enumerate(zip(params, specs)):
        if pre == "pool":
            x = maxpool_2x2_ceil(x)
        if k == 3:
            x = reflect_pad(x, 1)
        x = conv2d_nhwc(x, w, b)
        if post == "relu":
            x = torch.relu(x)
        if i in tap_after:
            taps.append(x)
    return taps


def decode(params, depth: int, feature: torch.Tensor,
           pad_mode: str = "reflect") -> torch.Tensor:
    """relu{depth}_1 NHWC features -> NHWC image (unclamped)."""
    return _run_stack(params, arch.decoder_specs(depth), feature, pad_mode)


class VGGBank:
    """Encoder/decoder params for depths 1..max_depth, on one device."""

    def __init__(self, max_depth: Optional[int] = None,
                 directory: Optional[str] = None, device="cpu"):
        avail = weights.available_depths(directory)
        if not avail:
            raise FileNotFoundError(
                "no converted VGG weights found — point OPTEX_WEIGHTS_DIR at "
                "a directory holding vgg_normalised_conv{d}_1.npz / "
                "feature_invertor_conv{d}_1.npz")
        self.max_depth = max_depth or max(avail)
        if self.max_depth not in avail:
            raise ValueError(f"depth {self.max_depth} unavailable; have {avail}")
        depths = range(1, self.max_depth + 1)
        self.enc_params = {d: weights.load_encoder_params(d, directory, device)
                           for d in depths}
        self.dec_params = {d: weights.load_decoder_params(d, directory, device)
                           for d in depths}

    @classmethod
    def from_params(cls, enc_params: Dict, dec_params: Dict) -> "VGGBank":
        bank = cls.__new__(cls)
        bank.max_depth = max(enc_params)
        bank.enc_params = dict(enc_params)
        bank.dec_params = dict(dec_params)
        return bank

    def to(self, device) -> "VGGBank":
        move = lambda ps: [(w.to(device), b.to(device)) for w, b in ps]
        return VGGBank.from_params(
            {d: move(p) for d, p in self.enc_params.items()},
            {d: move(p) for d, p in self.dec_params.items()})


def synthetic_bank(max_depth: int = 5, seed: int = 0, device="cpu") -> VGGBank:
    """He-scaled random weights for every depth 1..max_depth.

    Draws the same numbers in the same order as the JAX package's
    ``synthetic_bank(max_depth, seed=seed)``, so the two banks are equal."""
    rng = np.random.default_rng(seed)

    def params_for(specs):
        return weights.to_torch(
            [(rng.normal(0.0, np.sqrt(2.0 / (k * k * cin)),
                         (k, k, cin, cout)).astype(np.float32),
              np.zeros((cout,), np.float32))
             for (cin, cout, k, _, _) in specs], device)

    enc = {d: params_for(arch.encoder_specs(d)) for d in range(1, max_depth + 1)}
    dec = {d: params_for(arch.decoder_specs(d)) for d in range(1, max_depth + 1)}
    return VGGBank.from_params(enc, dec)
