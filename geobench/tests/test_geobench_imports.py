"""Nothing the benchmark runs loads JAX or the JAX package (`repro`): a
scan of its sources by whole top-level names, and of what a run on the CPU
has loaded once its window has closed; the reference imports nothing of
the program."""

import ast
import subprocess
import sys

import pytest

from geobench import harness, spec

HERE = spec.HERE
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = top_level_imports(path)
    assert not names & set(harness.FORBIDDEN)
    assert not names & {"chip_smoke", "benchmarks"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert top_level_imports(path) <= {"__future__", "contextlib", "math",
                                           "torch", "numpy"}, path
        # relative imports stay inside reference/
        assert all(node.level <= 1 for node in ast.walk(ast.parse(
            path.read_text())) if isinstance(node, ast.ImportFrom)), path


def test_forbidden_names_compare_whole():
    # the port's name begins with the JAX package's
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN


def test_a_run_loads_neither():
    code = (
        "import sys, torch\n"
        "from geobench import harness, program, spec\n"
        "cell = spec.cell('tpu65k.loglik')\n"
        "cell.config.update(n=256, nb=32, diag_thick=2)\n"
        "harness.measure(cell, seed=9, seconds=0.2, trace=False, device='cpu',"
        " t_start=0.0, make_entry=program.entry)\n"
        "print(sorted(k for k in sys.modules if k.startswith('repro_torch'))[:1])\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{spec.ROOT / 'src'}:{spec.ROOT}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert loaded == "['repro_torch']" and forbidden == "[]"
