"""Receiver operations of the port: host constants, plain versions and CUDA kernel wrappers.

The counterpart of ``qampy_tpu.ops``: the granular modules ``equaliser``,
``phase`` and ``pilots`` and the blind chain's ``make_rx_chain``. They are
imported at their first use: the modules below this package import each
other, and ``ops._build`` is imported by the kernel modules themselves, so
an eager import here would enter them half-made.
"""
import importlib

_MODULES = ("equaliser", "phase", "pilots")


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module("qampy_tpu_torch.ops." + name)
    if name == "make_rx_chain":
        from qampy_tpu_torch.ops.chain import make_rx_chain
        return make_rx_chain
    raise AttributeError(name)
