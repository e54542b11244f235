"""qampy_tpu_torch — the PyTorch/CUDA port of ``qampy_tpu`` for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. This first slice is the blind dual-pol
64-QAM receiver in ``decimated[K]`` mode (``ops.chain.make_rx_chain``),
carried by four hand-written CUDA kernels (``csrc/``): the block-LMS
trainer, the strided MIMO filter, the blind phase search and the
piecewise-linear derotation.

Importing the package compiles nothing: the kernels are built by ``nvcc``
at their first launch (``ops/_build.py``). The package imports ``torch``
and numpy only, never ``jax``.
"""
from qampy_tpu_torch.ops.chain import RxChain, make_rx_chain

__all__ = ["RxChain", "make_rx_chain"]
