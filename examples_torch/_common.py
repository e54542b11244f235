"""Shared bootstrap of the port's examples: the repository on ``sys.path``, ``--device``.

Each example is a script with a ``main(device=None, **sizes) -> dict`` that
runs it at its own sizes by default, prints what the JAX package's example
of the same file name prints, and returns the figures that its ``GATES``
hold. ``device=None`` is the card and raises on a machine without one; pass
``--device cpu`` (or ``device="cpu"``) for the CPU.
"""
import argparse
import importlib.util
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

NAMES = tuple(sorted(p.stem for p in HERE.glob("*.py") if not p.stem.startswith("_")))


def cli(doc=None):
    """The example's command line: ``{"device": ...}`` for its ``main``."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the CPU")
    return vars(ap.parse_args())


def gen(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the JAX example's key)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def load(name):
    """The example ``name`` (its file name without ``.py``) as a module, not run."""
    spec = importlib.util.spec_from_file_location("examples_torch_" + name, HERE / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gate_failures(gates, res):
    """The gates of ``gates`` ({figure: (op, limit)}) that ``res`` misses, as text.

    ``op`` is "<=", ">=" or "=="; a figure that is a list is held element by
    element.
    """
    ops = {"<=": lambda v, g: v <= g, ">=": lambda v, g: v >= g, "==": lambda v, g: v == g}
    bad = []
    for key, (op, limit) in gates.items():
        vals = res[key] if isinstance(res[key], (list, tuple)) else [res[key]]
        ok = all(ops[op](v, limit) for v in vals)
        if not ok:
            bad.append("%s = %s, gate %s %s" % (key, res[key], op, limit))
    return bad
