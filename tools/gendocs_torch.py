"""Generate the port's API reference (docs/api_torch/*.md) from its docstrings.

The counterpart of tools/gendocs.py for ``qampy_tpu_torch``, with the same
page layout: one Markdown page per module (the module docstring, public
constants, functions with signature and docstring, classes with their
public methods and properties) and an index. It imports torch and the port
only, never JAX, and needs no card: importing a module of the port builds
no kernel. Run: ``python tools/gendocs_torch.py``.
"""
from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

import qampy_tpu_torch  # noqa: E402

OUT = os.path.join(ROOT, "docs", "api_torch")


def modules():
    """Every module of the package, the package first, in name order."""
    names = [m.name for m in pkgutil.walk_packages(qampy_tpu_torch.__path__, "qampy_tpu_torch.")]
    return ["qampy_tpu_torch"] + sorted(n for n in names if not n.split(".")[-1].startswith("_"))


def _sig(obj):
    try:
        return str(inspect.signature(inspect.unwrap(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return indent + "*(no docstring)*\n"
    return "\n".join(indent + line for line in d.splitlines()) + "\n"


def _is_public(name, obj, modname, mod):
    if name.startswith("_"):
        return False
    if inspect.ismodule(obj):
        return False
    m = getattr(obj, "__module__", modname)
    # a package's re-exports and its __all__ are its surface; elsewhere the module's own names
    return (hasattr(mod, "__path__") or name in getattr(mod, "__all__", ()) or m == modname
            or m is None)


def render_module(modname):
    mod = importlib.import_module(modname)
    lines = ["# `%s`" % modname, ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    funcs, classes, consts = [], [], []
    names = getattr(mod, "__all__", None) or sorted(vars(mod))
    seen = set()
    for name in names:
        if name in seen or not hasattr(mod, name):
            continue
        seen.add(name)
        obj = getattr(mod, name)
        if not _is_public(name, obj, modname, mod):
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            funcs.append((name, obj))
        elif isinstance(obj, (tuple, float, int, str)) and name.isupper():
            consts.append((name, obj))
    if consts:
        lines += ["## Constants", ""]
        lines += ["- `%s = %r`" % (name, obj) for name, obj in consts]
        lines += [""]
    if funcs:
        lines += ["## Functions", ""]
        for name, obj in funcs:
            lines += ["### `%s%s`" % (name, _sig(obj)), "", _doc(obj)]
    if classes:
        lines += ["## Classes", ""]
        for name, cls in classes:
            lines += ["### `%s%s`" % (name, _sig(cls)), "", _doc(cls)]
            for mname, meth in sorted(vars(cls).items()):
                if mname.startswith("_"):
                    continue
                if isinstance(meth, property):
                    lines += ["#### `%s.%s` *(property)*" % (name, mname), "", _doc(meth)]
                elif callable(meth) or isinstance(meth, (staticmethod, classmethod)):
                    f = meth.__func__ if isinstance(meth, (staticmethod, classmethod)) else meth
                    lines += ["#### `%s.%s%s`" % (name, mname, _sig(f)), "", _doc(f)]
    return "\n".join(lines) + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# qampy_tpu_torch API reference", "",
             "Generated from the port's docstrings by `tools/gendocs_torch.py`. The JAX "
             "package's reference is [docs/api](../api/index.md); the map from one to the other "
             "is [docs/PARITY_TORCH.md](../PARITY_TORCH.md).", ""]
    mods = modules()
    for modname in mods:
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(OUT, fname), "w") as f:
            f.write(render_module(modname))
        mod = importlib.import_module(modname)
        first = inspect.cleandoc(mod.__doc__).splitlines()[0] if mod.__doc__ else ""
        index.append("- [`%s`](%s) — %s" % (modname, fname, first))
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote %d module pages to %s" % (len(mods) + 1, os.path.normpath(OUT)))


if __name__ == "__main__":
    main()
