"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ctypes. The build
runs at the first kernel launch, never at import, so the package imports
on a machine without ``nvcc``. The library lives under ``build/`` at the
repository root, in a directory keyed by a hash of the sources and flags;
a finished build is reused. Never add ``--use_fast_math``: the derotation
kernel needs the precise ``sincosf`` (see ``csrc/phase.cu``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "qampy_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libqampy_tpu_torch.so"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (restype, argtypes) of every C entry point
SIGNATURES = {
    "qtt_train_block_smem": (_LL, [_I, _I, _I, _I, _I]),
    "qtt_train_block": (_I, [_P, _I, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _F, _F, _F, _F, _F, _F, _I, _P]),
    "qtt_apply_filter_smem": (_LL, [_I, _I, _I, _I]),
    "qtt_apply_filter": (_I, [_P, _I, _LL, _P, _I, _I, _I, _LL, _P, _I, _LL, _P, _P]),
    "qtt_bps_smem": (_LL, [_I, _I]),
    "qtt_bps_idx": (_I, [_P, _P, _I, _LL, _P, _P, _I, _I, _F, _F, _P, _P]),
    "qtt_interp_rotate": (_I, [_P, _P, _P, _P, _I, _LL, _LL, _I, _I, _P, _P, _P]),
    "qtt_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                           "the CUDA kernels need the CUDA toolkit")
    return path


def build_dir():
    """The build directory of the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.cache
def library():
    """Build (once per source hash) and load the kernel library."""
    out_dir = build_dir()
    so = out_dir / LIB_NAME
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / ("%s.%d.tmp" % (LIB_NAME, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sorted(CSRC.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s" % (res.returncode, res.stderr[-4000:]))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(rc, what):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().qtt_error_string(rc).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))


def stream_of(t):
    """PyTorch's current CUDA stream on the device of tensor ``t``, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what, *tensors, dtype=None, contiguous=True):
    """Check that every tensor is a (contiguous) CUDA tensor of ``dtype``."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("%s launches a CUDA kernel: got a tensor on %s"
                             % (what, t.device))
        if dtype is not None and t.dtype != dtype:
            raise TypeError("%s needs %s tensors, got %s" % (what, dtype, t.dtype))
        if contiguous and not t.is_contiguous():
            raise ValueError("%s needs contiguous tensors" % what)
    if len({t.device for t in tensors}) > 1:
        raise ValueError("%s: tensors lie on different devices" % what)
