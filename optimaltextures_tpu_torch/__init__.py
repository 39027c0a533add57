"""optimaltextures_tpu_torch — the PyTorch/CUDA port of optimaltextures_tpu.

Texture synthesis and style transfer by sliced optimal transport in VGG-19
feature space, on an NVIDIA H100. The module layout mirrors the JAX package
module for module; the relu1/relu2-scale codec convolutions and the cdf
step's histogram and PWL remap run on hand-written CUDA kernels
(``csrc/codec.cu`` and ``csrc/cdf.cu``, wrapped by :mod:`.ops.codec` and
:mod:`.ops.cdf`).
"""

__version__ = "0.1.0"

from .config import OptexConfig  # noqa: F401
