"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ctypes (``csrc/grid.cuh`` is
the one header, shared by the sources). The build runs at
the first kernel launch, never at import, so the package imports on a
machine without ``nvcc``. The library lives under ``build/`` at the
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libqampy_tpu_torch.so"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# (restype, argtypes) of every C entry point
SIGNATURES = {
    "qtt_train_block_smem": (_LL, [_I, _I, _I, _I, _I, _I]),
    "qtt_train_block": (_I, [_P, _I, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _P, _I, _P, _I, _I, _P]),
    "qtt_train_seq": (_I, [_P, _I, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P]),
    "qtt_filter_plan": (None, [_I, _I, _I, _I, _LL, _I, _P]),
    "qtt_apply_filter": (_I, [_P, _I, _LL, _P, _I, _I, _I, _LL, _P, _I, _LL, _P, _P]),
    "qtt_bps_plan": (None, [_I, _LL, _I, _I, _P]),
    "qtt_bps_idx": (_I, [_P, _P, _I, _LL, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _I, _P, _P]),
    "qtt_interp_rotate": (_I, [_P, _P, _P, _P, _I, _LL, _LL, _I, _I, _P, _P, _P]),
    "qtt_apply_filter_frames": (_I, [_P, _I, _LL, _P, _P, _I, _I, _I, _I, _LL, _P, _I, _I, _I,
                                     _P, _P]),
    "qtt_rotate": (_I, [_P, _P, _P, _LL, _I, _P, _P, _P]),
    "qtt_cpe_plan": (None, [_LL, _I, _I, _P]),
    "qtt_cpe_coeffs": (_I, [_P, _P, _I, _LL, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _F, _P, _P, _P]),
    "qtt_unwrap_tiles": (_I, [_LL]),
    "qtt_unwrap_derotate": (_I, [_P, _P, _P, _I, _LL, _F, _F, _P, _P, _P, _P]),
    "qtt_bps_fine_plan": (None, [_I, _LL, _I, _I, _P]),
    "qtt_bps_bf16_plan": (None, [_I, _I, _LL, _I, _I, _I, _P]),
    "qtt_bps_idx_bf16": (_I, [_P, _P, _I, _LL, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P, _I,
                              _P, _P]),
    "qtt_bps_fine_bf16": (_I, [_P, _P, _P, _I, _LL, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P,
                               _I, _F, _F, _P, _P]),
    "qtt_bps_fine": (_I, [_P, _P, _P, _I, _LL, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _I, _F,
                          _F, _P, _P]),
    "qtt_div_check": (_I, [_P, _P, _I, _P, _P]),
    "qtt_probe_values": (_I, []),
    "qtt_probe_latency": (_I, [_P, _P, _I, _I, _P]),
    "qtt_probe_empty": (_I, [_I, _P]),
    "qtt_probe_copy": (_I, [_P, _P, _LL, _I, _I, _P]),
    "qtt_probe_argmin": (_I, [_P, _P, _LL, _I, _P]),
    "qtt_probe_deinterleave": (_I, [_P, _P, _I, _LL, _P]),
    "qtt_error_string": (ctypes.c_char_p, [_I]),
}


class KernelLimit(ValueError):
    """A launch that a kernel does not take and a plain backend does.

    Raised by the launchers' host checks for the limits of the kernels
    themselves (output modes, codebook entries, block size, shared memory,
    points of a general alphabet), with the limit and the backend to take
    instead in the message. ``backend="auto"`` catches exactly this to pick
    the plain trainer; an error in the caller's arguments is a plain
    ``ValueError`` and reaches the caller from every backend.
    """


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
    for src in sorted(CSRC.glob("*.cu*")):         # the sources and the header they share
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
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [out_dir / ("%s.%d.o" % (s.stem, os.getpid())) for s in srcs]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for o, s in zip(objs, srcs)]
        cmds.append([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
        # one nvcc per source, all at once; each writes to a file of its own
        outs = [o.with_suffix(".log") for o in objs]
        procs = [subprocess.Popen(c, stdout=f.open("w"), stderr=subprocess.STDOUT)
                 for c, f in zip(cmds, outs)]
        ok = all([p.wait() == 0 for p in procs])
        logs = [f.read_text() for f in outs]
        if ok:
            link = subprocess.run(cmds[-1], capture_output=True, text=True, check=False)
            logs.append(link.stdout + link.stderr)
            ok = link.returncode == 0
        log = "".join(" ".join(c) + "\n" + out for c, out in zip(cmds, logs))
        (out_dir / "build.log").write_text(log)
        for f in (*objs, *outs):
            f.unlink(missing_ok=True)
        if not ok:
            raise RuntimeError("nvcc failed:\n%s" % log[-4000:])
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
