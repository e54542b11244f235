"""What the benchmark imports: never JAX or the JAX package; the yardstick nothing of the program."""
import ast
from pathlib import Path

import pytest

from benchmark.lib import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "qampy_tpu"}


def top_level_imports(path):
    """The top-level names of every module a file imports (``a`` of ``import a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in ("reference", "gen")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_and_generators_import_nothing_of_the_program(path):
    assert "qampy_tpu_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's: only whole top-level names count."""
    assert top_level_imports.__doc__
    assert harness.forbidden_modules(["qampy_tpu_torch", "qampy_tpu_torch.ops", "torch"]) == []
    assert harness.forbidden_modules(["qampy_tpu.ops.chain", "torch"]) == ["qampy_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "jax"]) == ["jax", "jaxlib"]


def test_the_ast_walk_sees_every_form_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom qampy_tpu.ops import chain\n"
                 "from . import sibling\nimport qampy_tpu_torch\n")
    assert top_level_imports(f) == {"jax", "qampy_tpu", "qampy_tpu_torch"}
