"""The port's package surface against the JAX package's, name by name.

Every module of ``qampy_tpu`` is read with ``ast`` (the surface check
imports none of them) and each public top-level name it defines, or re-exports
from a package ``__init__``, must be an attribute of its counterpart in
``qampy_tpu_torch`` (the same dotted path), unless it stands on the
exception lists below with its reason. A name a module imports only for
its own use is not its surface; those the port lacks are listed too.
Then the surface the reference documents: ``ops.make_rx_chain``, the
``bps_af``/``bps_pyx`` aliases, ``erfc`` and ``pallas_eligibility``. Then
the parameters: each parameter name of each public function and method
(``__init__`` included, properties not) that a reference module defines
must be a parameter of its counterpart, unless it stands on
``PARAM_EXCEPTIONS`` with its reason (private ``_name`` parameters aside).
"""
import ast
import importlib
import inspect
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
# up to 256 points) and blocks that are a multiple of 32 but not of 128. bps_tile tiles the
# bf16 window sums, a multiple of 128 in both.
CASES = {
    "square grid": (("square64", ("mcma", "mddma"), 256, 16384), (True, True)),
    "cross grid, rde": (("cross32", ("mcma", "rde"), 128, 2048), (True, True)),
    "unknown method": (("square64", ("mcma", "mrde"), 256, None), (False, False)),
    "odd block size": (("square64", ("cma",), 100, None), (False, False)),
    "ring alphabet": (("ring8", ("mcma", "sbd"), 256, None), (True, False)),
    "block of 64": (("square64", ("cma",), 64, None), (True, False)),
    "unaligned bps_tile": (("square64", ("cma",), None, 1000), (False, False)),
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


# (module, function or Class.method, parameter): why the port's counterpart does not take it.
# Only idiom differences: JAX's random keys and runtime, against torch's generators and
# torch.distributed.
_KEY = "a jax.random key: the port draws from a torch.Generator (``generator=``)"
PARAM_EXCEPTIONS = {
    ("qampy_tpu.core.impairments", "phase_noise", "key"): _KEY,
    ("qampy_tpu.core.impairments", "apply_phase_noise", "key"): _KEY,
    ("qampy_tpu.core.impairments", "add_awgn", "key"): _KEY,
    ("qampy_tpu.core.impairments", "change_snr", "key"): _KEY,
    ("qampy_tpu.core.impairments", "simulate_transmission", "key"): _KEY,
    ("qampy_tpu.core.impairments", "apply_enob_as_awgn", "key"): _KEY,
    ("qampy_tpu.core.pilotbased_transmitter", "sim_tx", "key"): _KEY,
    ("qampy_tpu.impairments", "add_awgn", "key"): _KEY,
    ("qampy_tpu.impairments", "apply_phase_noise", "key"): _KEY,
    ("qampy_tpu.impairments", "change_snr", "key"): _KEY,
    ("qampy_tpu.impairments", "simulate_transmission", "key"): _KEY,
    ("qampy_tpu.ops.equaliser", "equalise_signal", "**kwargs"):
        "the reference takes **kwargs and reads none (it hands them only to itself); the "
        "port refuses an unknown keyword",
    ("qampy_tpu.ops.equaliser", "dual_mode_equalisation", "**kwargs"): "the same",
    ("qampy_tpu.parallel.mesh", "init_distributed", "local_device_count"):
        "JAX's multi-controller runtime (devices per process): a torch.distributed rank "
        "drives one device",
    ("qampy_tpu.parallel.mesh", "init_distributed", "platform"):
        "JAX's backend name: the port takes ``backend`` (gloo, nccl) and ``device``",
    ("qampy_tpu.parallel.mesh", "init_distributed", "cpu_collectives"): "the same",
    ("qampy_tpu.parallel.mesh", "make_mesh", "n_devices"):
        "a mesh over JAX devices: the port's mesh is a torch.distributed group (``group``)",
    ("qampy_tpu.parallel.mesh", "make_mesh", "devices"): "the same",
    ("qampy_tpu.parallel.sharded", "shard_signal", "spec"):
        "a jax.sharding PartitionSpec: a rank holds its contiguous time slice",
}


def _is_property(fn):
    return any(isinstance(d, (ast.Name, ast.Attribute)) and
               (getattr(d, "id", None) == "property" or getattr(d, "attr", None) == "setter")
               for d in fn.decorator_list)


def _reference_callables(path):
    """(qualified name, ast function) of a module's public functions and its public
    classes' public methods and __init__ (properties left out)."""
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.FunctionDef) and not n.name.startswith("_"):
            yield n.name, n
        elif isinstance(n, ast.ClassDef) and not n.name.startswith("_"):
            for m in n.body:
                if (isinstance(m, ast.FunctionDef) and not _is_property(m)
                        and (not m.name.startswith("_") or m.name == "__init__")):
                    yield n.name + "." + m.name, m


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls") and not n.startswith("_")]


def _lacks(obj, name):
    """Whether callable ``obj`` takes no parameter ``name`` (``*args``/``**kw`` by kind)."""
    ps = inspect.signature(obj).parameters.values()
    if name.startswith("**"):
        return not any(p.kind == p.VAR_KEYWORD for p in ps)
    if name.startswith("*"):
        return not any(p.kind == p.VAR_POSITIONAL for p in ps)
    return name not in {p.name for p in ps} and not any(p.kind == p.VAR_KEYWORD for p in ps)


def _missing_params(mod, path):
    port = importlib.import_module(mod.replace("qampy_tpu", "qampy_tpu_torch", 1))
    missing = []
    for qual, fn in _reference_callables(path):
        obj = port
        for part in qual.split("."):
            obj = getattr(obj, part)
        missing += [(mod, qual, p) for p in _params(fn) if _lacks(obj, p)]
    return missing


SIG_MODULES = [(m, p) for m, p in MODULES if m not in MODULE_EXCEPTIONS]


@pytest.mark.parametrize("mod, path", SIG_MODULES, ids=[m for m, _ in SIG_MODULES])
def test_every_parameter_has_a_counterpart(mod, path):
    unlisted = [m for m in _missing_params(mod, path) if m not in PARAM_EXCEPTIONS]
    assert not unlisted, "parameters the port does not take: %s" % unlisted


def test_parameter_exceptions_are_needed():
    """Each listed parameter is still missing from its counterpart (else it comes off the
    list), and each has its reason."""
    paths = dict(MODULES)
    missing = {m for mod in {k[0] for k in PARAM_EXCEPTIONS}
               for m in _missing_params(mod, paths[mod])}
    assert set(PARAM_EXCEPTIONS) <= missing
    assert all(PARAM_EXCEPTIONS.values())


def test_the_modes_ported_last_are_no_exception():
    """The reference's selectable modes are parameters of the port, not exceptions."""
    listed = {(q, p) for _, q, p in PARAM_EXCEPTIONS}
    for qual, p in (("make_rx_chain", "bps_win"), ("make_rx_chain", "pallas"),
                    ("make_rx_chain", "bps_tile"), ("make_rx_chain", "fuse_derot"),
                    ("make_pilot_rx_chain", "frames_unroll"),
                    ("make_pilot_rx_chain", "frames_pack"),
                    ("apply_filter_to_signal", "precision")):
        assert (qual, p) not in listed
