"""qampy_tpu_torch — the PyTorch/CUDA port of ``qampy_tpu`` for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against. It runs:

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
  (``backend="cuda"``, ``"cuda_block"``);
- the signal objects (``signals``: ``SignalQAMGrayCoded`` and its PSK,
  BERT and symbol-only siblings, ``TDHQAMSymbols``, ``SignalWithPilots``)
  with their metrics (``core.metrics``, ``core.sync``), ``theory``,
  ``helpers``, ``prbs``, and the rest of carrier recovery on them
  (``phaserec``: the blind phase search and its two-stage form on the
  search, fine-stage and rotation kernels, Viterbi-Viterbi, the 16-QAM
  partition, FOE and the pilot CPE);
- the transmitter side and the signal-object adapters: filters (FFT,
  root-raised cosine, the Bessel and Butterworth IIR filters in one
  doubling form of their recurrence) and resampling (``core.filter``,
  ``core.resample``, ``Signal.resample``, ``ResampledQAM``), the
  transmitter's models and pre-compensation (``core.impairments``,
  ``core.digital_pre_compensation``), ``core.analog_frontend``,
  ``core.pilotbased_transmitter``, saving and loading (``core.io``), and on
  signal objects ``equalisation`` (a pilot signal's frames filtered by the
  filter's frame entry), ``impairments``, ``filtering``,
  ``analog_frontend`` and ``io``.

Entry points run on the card unless the caller names another device
(``device="cpu"``); on a machine without a card they raise.

Importing the package compiles nothing: the kernels are built by ``nvcc``
at their first launch (``ops/_build.py``). The package imports ``torch``
and numpy only, never ``jax``.
"""
from qampy_tpu_torch.ops.chain import RxChain, make_rx_chain
from qampy_tpu_torch.ops.equaliser import dual_mode_equalisation, equalise_signal
from qampy_tpu_torch.ops.pilot_chain import PilotRxChain, make_pilot_rx_chain
from qampy_tpu_torch.signals import (PRBSBits, QPSKfromBERT, RandomBits, ResampledQAM, Signal,
                                     SignalBase, SignalPSKGrayCoded, SignalQAMGrayCoded,
                                     SignalWithPilots, SymbolOnlySignal, TDHQAMSymbols)
from qampy_tpu_torch import core, helpers, prbs, theory, utils  # noqa: E402
from qampy_tpu_torch import (analog_frontend, equalisation, filtering,  # noqa: E402
                             impairments, io, phaserec)

__all__ = ["RxChain", "make_rx_chain", "PilotRxChain", "make_pilot_rx_chain",
           "equalise_signal", "dual_mode_equalisation", "Signal", "SignalBase",
           "SignalQAMGrayCoded", "SignalPSKGrayCoded", "QPSKfromBERT", "SymbolOnlySignal",
           "TDHQAMSymbols", "SignalWithPilots", "ResampledQAM", "RandomBits", "PRBSBits",
           "core", "helpers", "prbs", "theory", "utils", "equalisation", "phaserec",
           "impairments", "filtering", "analog_frontend", "io"]
