"""Architecture tables for the normalised-VGG-19 encoder / feature-inverter banks.

A copy of ``optimaltextures_tpu/models/arch.py`` (the port imports nothing
from the JAX package). The upstream reference (``vgg.py:14-135``) builds torch
``Sequential`` stacks from nested lists of modules; here the same networks are
described as *data* — flat tuples of conv descriptors — which the forward
passes (:mod:`.vgg`) and the weight loader (:mod:`.weights`) consume.

Conventions
-----------
* ``ConvSpec = (cin, cout, ksize, pre, post)`` where ``pre`` is an op applied
  *before* the conv ("pool" = 2x2 ceil-mode max-pool, "up" = nearest x2
  upsample, "" = nothing) and ``post`` is "relu" or "".
* All 3x3 convs are reflection-padded by 1 (the reference never uses padded
  convs — ``vgg.py:15-135`` interleaves ``ReflectionPad2d``); the single 1x1
  conv at the encoder entry (RGB renormalisation, ``vgg.py:16``) is unpadded.
* Encoder depth ``d`` ends at relu{d}_1; decoder depth ``d`` inverts relu{d}_1
  back to pixels. Feature channel counts per depth: 64, 128, 256, 512, 512.
"""

from __future__ import annotations

from typing import List, Tuple

ConvSpec = Tuple[int, int, int, str, str]

# Per-depth channel count of the relu{d}_1 feature map.
FEATURE_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}

# Spatial downscale factor of the relu{d}_1 feature map.
FEATURE_STRIDE = {1: 1, 2: 2, 3: 4, 4: 8, 5: 16}

# The full 5-block encoder as a flat list of conv specs (reference
# ``vgg.py:14-74``). Block boundaries are implied by the "pool" markers.
_ENCODER_FULL: List[ConvSpec] = [
    (3, 3, 1, "", ""),          # RGB renorm 1x1, no pad, no relu
    (3, 64, 3, "", "relu"),     # -> relu1_1
    (64, 64, 3, "", "relu"),
    (64, 128, 3, "pool", "relu"),   # -> relu2_1
    (128, 128, 3, "", "relu"),
    (128, 256, 3, "pool", "relu"),  # -> relu3_1
    (256, 256, 3, "", "relu"),
    (256, 256, 3, "", "relu"),
    (256, 256, 3, "", "relu"),
    (256, 512, 3, "pool", "relu"),  # -> relu4_1
    (512, 512, 3, "", "relu"),
    (512, 512, 3, "", "relu"),
    (512, 512, 3, "", "relu"),
    (512, 512, 3, "pool", "relu"),  # -> relu5_1
]

# Number of convs (including the 1x1) in an encoder of each depth.
_ENCODER_LEN = {1: 2, 2: 4, 3: 6, 4: 10, 5: 14}

# The full 5-block feature inverter, deepest block first (reference
# ``vgg.py:77-135``). Decoder(d) uses the *last* d blocks, i.e. a suffix.
_DECODER_FULL: List[ConvSpec] = [
    # inverts relu5_1
    (512, 512, 3, "", "relu"),
    (512, 512, 3, "up", "relu"),
    (512, 512, 3, "", "relu"),
    (512, 512, 3, "", "relu"),
    # inverts relu4_1
    (512, 256, 3, "", "relu"),
    (256, 256, 3, "up", "relu"),
    (256, 256, 3, "", "relu"),
    (256, 256, 3, "", "relu"),
    # inverts relu3_1
    (256, 128, 3, "", "relu"),
    (128, 128, 3, "up", "relu"),
    # inverts relu2_1
    (128, 64, 3, "", "relu"),
    (64, 64, 3, "up", "relu"),
    # inverts relu1_1 — final conv has NO activation/clamp (vgg.py:130-134)
    (64, 3, 3, "", ""),
]

# Decoder(d) = suffix of _DECODER_FULL with this many convs.
_DECODER_LEN = {1: 1, 2: 3, 3: 5, 4: 9, 5: 13}


def encoder_specs(depth: int) -> List[ConvSpec]:
    """Conv specs for the encoder truncated at relu{depth}_1."""
    if not 1 <= depth <= 5:
        raise ValueError(f"encoder depth must be in 1..5, got {depth}")
    return _ENCODER_FULL[: _ENCODER_LEN[depth]]


def decoder_specs(depth: int) -> List[ConvSpec]:
    """Conv specs for the decoder inverting relu{depth}_1."""
    if not 1 <= depth <= 5:
        raise ValueError(f"decoder depth must be in 1..5, got {depth}")
    specs = _DECODER_FULL[len(_DECODER_FULL) - _DECODER_LEN[depth]:]
    # A decoder always *starts* fresh at its own depth: the first conv of a
    # suffix never carries the "up" marker of the block above it.
    first = specs[0]
    if first[3] == "up":
        specs = [(first[0], first[1], first[2], "", first[4])] + specs[1:]
    return specs


def torch_sequential_indices(specs: List[ConvSpec], decoder: bool = False) -> List[int]:
    """Flat ``nn.Sequential`` indices the reference checkpoints key convs by.

    The reference stores weights as ``"{i}.weight"`` where ``i`` is the index
    of the conv inside the flattened Sequential (pads/relus/pools/upsamples
    occupy indices too). Reconstructing those indices from the spec table lets
    the converter read the ``.pth`` files without replicating torch modules.
    """
    idxs = []
    i = 0
    for (_, _, k, pre, post) in specs:
        if pre == "pool" or pre == "up":
            i += 1
        if k == 3:
            i += 1  # ReflectionPad2d
        idxs.append(i)
        i += 1  # the conv itself
        if post == "relu":
            i += 1
    return idxs
