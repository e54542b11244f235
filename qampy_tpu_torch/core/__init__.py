"""Core DSP functions of the port on tensors (counterpart of ``qampy_tpu/core``).

Plain tensors in, plain tensors out; the signal-object adapters are the
package's top-level modules. The submodules (``analog_frontend``,
``digital_pre_compensation``, ``filter``, ``impairments``, ``io``,
``metrics``, ``pilotbased_transmitter``, ``resample``, ``special``,
``sync``) and the reference's module names for them (``ber_functions``,
``signal_quality``, ``special_fcts``; ``equalisation``, ``phaserecovery``
and ``pilotbased_receiver`` for the ``ops`` modules; ``prbs``, ``utils``)
are imported at their first use: the modules below this package import
each other's submodules, which an eager import here would enter half-made.
"""
import importlib

_MODULES = {name: "qampy_tpu_torch.core." + name for name in (
    "analog_frontend", "digital_pre_compensation", "filter", "impairments", "io", "metrics",
    "pilotbased_transmitter", "resample", "special", "sync")}
_MODULES.update(ber_functions="qampy_tpu_torch.core.sync",
                signal_quality="qampy_tpu_torch.core.metrics",
                special_fcts="qampy_tpu_torch.core.special",
                equalisation="qampy_tpu_torch.ops.equaliser",
                phaserecovery="qampy_tpu_torch.ops.phase",
                pilotbased_receiver="qampy_tpu_torch.ops.pilots",
                prbs="qampy_tpu_torch.prbs",
                utils="qampy_tpu_torch.utils")


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(_MODULES[name])
    raise AttributeError(name)
