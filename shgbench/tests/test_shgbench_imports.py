"""No module of the benchmark imports JAX or the JAX package, and the
reference, the generator and the yardsticks import nothing of the
program.  Names are compared by their whole top-level part."""

import ast

import pytest

from shgbench.harness import BENCH_DIR

JAX = {"jax", "jaxlib", "flax", "solex_ser_recon_en_tpu"}
PROGRAM = "solex_ser_recon_en_torch"
#: modules that stand apart from the program under test
INDEPENDENT = ("reference/", "generator.py", "roofline.py", "compare.py",
               "trace.py", "metrics/")


def _tops(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


FILES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH_DIR)))
def test_no_jax(path):
    assert not set(_tops(path)) & JAX


@pytest.mark.parametrize("path", [p for p in FILES if str(p.relative_to(
    BENCH_DIR)).startswith(INDEPENDENT)], ids=lambda p: str(p.relative_to(
        BENCH_DIR)))
def test_independent_of_the_program(path):
    assert PROGRAM not in set(_tops(path))


def test_whole_names_are_compared():
    assert "solex_ser_recon_en_torch" not in JAX
    assert PROGRAM.startswith("solex_ser_recon_en_t")
