"""What the benchmark may import and read: no module under ``benchmark/``
imports JAX or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's), the reference imports nothing of the
port, and nothing names the JAX repo's measurement tools or figures."""

import ast
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "simple_spectral_tpu"}
# files of the JAX repo that no benchmark file may read
FORBIDDEN_READS = re.compile(r"(^|[/\"'])(tools/|bench\.py|BENCH_[^/]*\.json|MULTICHIP_[^/]*\.json)")


def sources():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


def test_sources_found():
    names = {os.path.relpath(p, BENCH) for p in sources()}
    assert {"run.py", "harness.py", "reference/integrator.py", "metrics/setup_s.py"} <= names


@pytest.mark.parametrize("path", list(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(imported_tops(path))


@pytest.mark.parametrize("path", [p for p in sources() if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "simple_spectral_torch" not in set(imported_tops(path))


@pytest.mark.parametrize("path", [p for p in sources() if os.sep + "tests" + os.sep not in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_read_of_the_jax_repos_figures(path):
    tree = ast.parse(open(path).read(), path)
    strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    # docstrings may name the port's own tools; no literal is a path to these files
    paths = [s for s in strings if "\n" not in s and FORBIDDEN_READS.search(s)]
    assert not paths, paths


def test_forbidden_names_compare_whole():
    import sys

    sys.path.insert(0, os.path.dirname(BENCH))
    from benchmark import harness

    assert set(harness.FORBIDDEN_MODULES) == FORBIDDEN
    sys.modules.setdefault("simple_spectral_torch_probe", object())
    try:
        assert "simple_spectral_torch_probe" not in harness.forbidden_loaded()
    finally:
        del sys.modules["simple_spectral_torch_probe"]
