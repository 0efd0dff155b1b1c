"""What the benchmark may import: nothing of JAX or the JAX package, not
the root bench.py; the reference nothing of the program either. Each
import's top-level name (before the first dot) is compared whole, since
the port's name begins with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "splatslam_tpu", "bench"}


def _modules(folder):
    for d, _, fs in os.walk(folder):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules(HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("path",
                         sorted(_modules(os.path.join(HERE, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    assert "splatslam_tpu_torch" not in set(_imports(path))
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            assert node.level == 1      # only the reference's own modules
