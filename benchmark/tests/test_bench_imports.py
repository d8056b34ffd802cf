"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name, and the plain reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import harness

from conftest import BENCH, CHECKOUT


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob('*.py'):
        if 'tests' not in path.parts:
            assert not _top_imports(path) & set(harness.FOREIGN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / 'reference').glob('*.py'):
        assert 'sgdml_tpu_torch' not in _top_imports(path) and 'sgdml_tpu' not in _top_imports(path), path
    code = ('import sys; sys.path.insert(0, %r); import benchmark.reference.train, benchmark.reference.md; '
            'print(sorted(m for m in sys.modules if m.split(".")[0].startswith("sgdml")))' % str(CHECKOUT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == '[]'


def test_a_run_loads_the_port_and_not_the_jax_package(tiny):
    code = ('import sys; sys.path[:0] = [%r, %r]; from benchmark import harness; '
            'cell = harness.load_cell("atat.serve_test", spec_path=%r, root=%r); '
            'r, foreign = harness.run_cell(cell, 7, 0.2, False, "cpu"); '
            'print(foreign, "sgdml_tpu_torch" in sys.modules, "jax" in sys.modules)'
            % (str(CHECKOUT), str(CHECKOUT / 'benchmark' / 'tests'), str(tiny[0]), str(tiny[1])))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == '[] True False'


def test_the_foreign_module_check_compares_whole_top_level_names(monkeypatch):
    before = harness.foreign_modules()
    monkeypatch.setitem(sys.modules, 'sgdml_tpu_torch_extra', sys)
    monkeypatch.setitem(sys.modules, 'jaxtyping', sys)
    assert harness.foreign_modules() == before
    monkeypatch.setitem(sys.modules, 'sgdml_tpu.train', sys)
    assert 'sgdml_tpu' in harness.foreign_modules()
