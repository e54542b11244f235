"""qampy_tpu_torch — the PyTorch/CUDA port of ``qampy_tpu`` for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. Four slices run:

- the blind dual-pol 64-QAM receiver in ``decimated[K]`` mode
  (``ops.chain.make_rx_chain``), carried by four hand-written CUDA kernels
  (``csrc/``): the block-LMS trainer, the strided MIMO filter, the blind
  phase search and the piecewise-linear derotation;
- the pilot serving chain (``ops.pilot_chain.make_pilot_rx_chain``) with
  the LMS pilot trainer (the default; the block trainer, one batched launch
  a stage) or the LS solve, pilot FOE compensation, and a frame body that
  batches the frames of a dispatch through the filter's frame entry, the
  pilot CPE coefficients and the derotation (or, with the phase trace or
  any other pilot layout, the rotation by a given phase);
- the granular pilot receiver (``ops.pilots``: frame sync on the
  per-symbol trainer, pilot equalisation, pilot FOE and CPE);
- the granular equaliser (``ops.equaliser.equalise_signal``,
  ``dual_mode_equalisation``, ``apply_filter``, ``CDcomp``): every error
  function, the exact per-symbol trainer and the block trainer in plain
  PyTorch (``backend="seq"``, ``"block"``) and as kernels
  (``backend="cuda"``, ``"cuda_block"``).

Entry points run on the card unless the caller names another device
(``device="cpu"``); on a machine without a card they raise.

Importing the package compiles nothing: the kernels are built by ``nvcc``
at their first launch (``ops/_build.py``). The package imports ``torch``
and numpy only, never ``jax``.
"""
from qampy_tpu_torch.ops.chain import RxChain, make_rx_chain
from qampy_tpu_torch.ops.equaliser import dual_mode_equalisation, equalise_signal
from qampy_tpu_torch.ops.pilot_chain import PilotRxChain, make_pilot_rx_chain

__all__ = ["RxChain", "make_rx_chain", "PilotRxChain", "make_pilot_rx_chain",
           "equalise_signal", "dual_mode_equalisation"]
