"""Nothing the benchmark runs imports JAX or the JAX package, top-level
names compared whole (the port's name begins with the JAX package's),
and the plain reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "oppositerenderer_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH_DIR / sub).rglob("*.py")
            if "tests" not in p.relative_to(BENCH_DIR).parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = FORBIDDEN & set(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_the_port_is_not_mistaken_for_the_jax_package():
    assert "oppositerenderer_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "oppositerenderer_tpu_torch" not in names, path
        assert "port_bench" not in names, path


def test_nothing_reads_the_jax_round_scripts():
    for path in _sources():
        text = path.read_text()
        for name in ("bench.py\"", "bench_torch", "scripts/",
                     "chip_smoke", "milestone4"):
            assert name not in text, f"{path} names {name}"
