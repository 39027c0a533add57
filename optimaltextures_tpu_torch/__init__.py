"""optimaltextures_tpu_torch — the PyTorch/CUDA port of optimaltextures_tpu.

Texture synthesis, style transfer and texture mixing by sliced optimal
transport in VGG-19 feature space, on an NVIDIA H100. The module layout
mirrors the JAX package module for module; the relu1/relu2-scale codec
convolutions and the cdf step's histogram and PWL remap run on hand-written
CUDA kernels (``csrc/codec.cu`` and ``csrc/cdf.cu``, wrapped by
:mod:`.ops.codec` and :mod:`.ops.cdf`), as do the legacy fused cdf apply
(:func:`.ops.cdf.cdf_remap`) and the 64 -> 64 conv prototype
(``csrc/conv64.cu``, :mod:`.ops.conv64`, driven by
:mod:`.tools.conv_proto`), which no path of the program calls.
"""

__version__ = "0.1.0"

from .config import OptexConfig  # noqa: F401
