"""The port's package surface against the JAX package's, name by name.

Every module of ``qampy_tpu`` is read with ``ast`` (the surface check
imports none of them) and each public top-level name it defines, or re-exports
from a package ``__init__``, must be an attribute of its counterpart in
``qampy_tpu_torch`` (the same dotted path), unless it stands on the
exception lists below with its reason. A name a module imports only for
its own use is not its surface; those the port lacks are listed too.
Then the surface the reference documents: ``ops.make_rx_chain``, the
``bps_af``/``bps_pyx`` aliases, ``erfc`` and ``pallas_eligibility``.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest

from qampy_tpu_torch import ops
from qampy_tpu_torch.ops import phase as phops
from qampy_tpu_torch.ops.chain import pallas_eligibility

REF = pathlib.Path(__file__).resolve().parents[1] / "qampy_tpu"

# modules with no counterpart of the same name
MODULE_EXCEPTIONS = {
    "qampy_tpu.ops.equaliser_pallas": "the Pallas kernels: their CUDA counterparts and wrappers "
                                      "are ops/equaliser_cuda.py",
    "qampy_tpu.ops.phase_pallas": "the Pallas kernels: their CUDA counterparts and wrappers "
                                  "are ops/phase_cuda.py",
    "qampy_tpu.ops._pallas_util": "helpers of the Pallas kernels' lane layout",
    "qampy_tpu.native": "the host C PRBS, on ROADMAP's 'Not to port' list: the port's numpy "
                        "make_prbs_extXOR is as fast",
}
# names defined by a reference module that the port drops on purpose
NAME_EXCEPTIONS = {
    ("qampy_tpu.core.filter", "IIR_ASSOC_MAX_STATE"): "the associative-scan IIR's limits: the "
                                                      "port has one doubling form (queue C)",
    ("qampy_tpu.core.filter", "IIR_ASSOC_MIN_SAMPLES"): "the same",
}
_JAX = "JAX itself, imported for the module's own use"
_OWN = "imported for the module's own use"
# names a reference module imports for its own use that the port's module does not hold
IMPORT_EXCEPTIONS = {
    "jax": _JAX, "jnp": _JAX, "lax": _JAX, "P": _JAX + " (PartitionSpec)",
    "partial": _OWN + " (functools)", "warnings": _OWN, "np": _OWN, "Signal": _OWN,
    "SignalQAMGrayCoded": _OWN, "helpers": _OWN, "cabssquared": _OWN, "cal_s0": _OWN,
    "segment_axis": _OWN, "ber_functions": _OWN, "core_filter": _OWN, "equaliser": _OWN,
    "phase": _OWN, "TIME": _OWN, "make_mesh": _OWN, "save_signal": _OWN, "theory": _OWN,
}


def _modules():
    for p in sorted(REF.rglob("*.py")):
        parts = p.relative_to(REF.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts), p


def _public(path):
    """(defined names, imported names) at the top level of a module's source."""
    tree = ast.parse(path.read_text())
    defs, imps = set(), set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defs.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                defs.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            imps.update((a.asname or a.name).split(".")[0] for a in n.names)
    if path.name == "__init__.py":                 # a package's imports are its surface
        defs |= imps
    pub = {n for n in defs if not n.startswith("_")}
    return pub, {n for n in imps - defs if not n.startswith("_")}


MODULES = list(_modules())


@pytest.mark.parametrize("mod, path", MODULES, ids=[m for m, _ in MODULES])
def test_every_public_name_has_a_counterpart(mod, path):
    if mod in MODULE_EXCEPTIONS:
        with pytest.raises(ImportError):
            importlib.import_module(mod.replace("qampy_tpu", "qampy_tpu_torch", 1))
        return
    port = importlib.import_module(mod.replace("qampy_tpu", "qampy_tpu_torch", 1))
    defined, imported = _public(path)
    missing = sorted(n for n in defined if not hasattr(port, n)
                     and (mod, n) not in NAME_EXCEPTIONS)
    assert not missing, "%s lacks %s" % (port.__name__, missing)
    unlisted = sorted(n for n in imported if not hasattr(port, n) and n not in IMPORT_EXCEPTIONS)
    assert not unlisted, "%s lacks %s, imported by the reference" % (port.__name__, unlisted)


def test_exception_lists_are_needed():
    """Each listed exception is still missing from the port (else it comes off the list)."""
    for (mod, name) in NAME_EXCEPTIONS:
        port = importlib.import_module(mod.replace("qampy_tpu", "qampy_tpu_torch", 1))
        assert not hasattr(port, name)
    listed = {m for m, _ in MODULES}
    assert set(MODULE_EXCEPTIONS) <= listed


def test_ops_surface():
    from qampy_tpu_torch.ops import chain, equaliser, phase, pilots
    assert ops.make_rx_chain is chain.make_rx_chain
    assert (ops.equaliser, ops.phase, ops.pilots) == (equaliser, phase, pilots)
    assert phops.bps_af is phops.bps and phops.bps_pyx is phops.bps
    with pytest.raises(AttributeError):
        ops.no_such_module


def test_erfc():
    from qampy_tpu_torch import theory
    from qampy_tpu_torch.core import special
    x = np.linspace(-3, 3, 13, dtype=np.float32)
    want = np.array([__import__("math").erfc(float(v)) for v in x], np.float32)
    for fn in (theory.erfc, special.erfc):
        np.testing.assert_allclose(fn(x).numpy(), want, rtol=2e-6, atol=1e-7)
        assert float(fn(0.0)) == 1.0


def _grids():
    from qampy_tpu_torch.theory import cal_symbols_qam
    ring = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    return {"square64": phops.detect_grid(cal_symbols_qam(64)),
            "cross32": phops.detect_grid(cal_symbols_qam(32)),
            "ring8": phops.detect_grid(ring)}


# (grid, methods, block_size, bps_tile): (port ok, reference ok). Rows where they differ are
# the CUDA rules that are not Pallas's lane rules: a general alphabet (the CUDA kernels search
# up to 256 points), blocks that are a multiple of 32 but not of 128, and bps_tile, which
# B3's own launch plan ignores.
CASES = {
    "square grid": (("square64", ("mcma", "mddma"), 256, 16384), (True, True)),
    "cross grid, rde": (("cross32", ("mcma", "rde"), 128, 2048), (True, True)),
    "unknown method": (("square64", ("mcma", "mrde"), 256, None), (False, False)),
    "odd block size": (("square64", ("cma",), 100, None), (False, False)),
    "ring alphabet": (("ring8", ("mcma", "sbd"), 256, None), (True, False)),
    "block of 64": (("square64", ("cma",), 64, None), (True, False)),
    "unaligned bps_tile": (("square64", ("cma",), None, 1000), (True, False)),
    "block past 1024": (("square64", ("cma",), 2048, None), (False, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pallas_eligibility(case):
    (grid, methods, block, tile), (ok_port, ok_ref) = CASES[case]
    ok, reasons = pallas_eligibility(_grids()[grid], methods, block, tile)
    assert ok == ok_port and (not reasons) == ok
    # the reference's answer, by its own function
    from qampy_tpu.ops import phase as jphase
    from qampy_tpu.ops.chain import pallas_eligibility as jax_eligibility
    from qampy_tpu.theory import cal_symbols_qam as jsyms
    ring = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    jgrid = {"square64": jphase.detect_grid(jsyms(64)), "cross32": jphase.detect_grid(jsyms(32)),
             "ring8": jphase.detect_grid(ring)}[grid]
    assert jax_eligibility(jgrid, methods, block, tile)[0] == ok_ref
