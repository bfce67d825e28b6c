"""What the harness and the reference load: never JAX or the JAX package,
and the reference nothing of the program. Module names are compared by
their top-level name whole (``fastoptsolver_tpu_torch`` begins with the JAX
package's name and is not it)."""
import ast
import json
import subprocess
import sys
import textwrap

from benchmark import run, spec

NEVER = {"jax", "jaxlib", "flax", "fastoptsolver_tpu"}
PROGRAM = "fastoptsolver_tpu_torch"


def _loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _loaded_after(textwrap.dedent("""
        import time, torch
        from benchmark import run, spec
        for name in ("boston5.small_batch", "wide96.high_alpha"):
            run.run_cell(spec.cell(name), 3, 0.2, False, torch.device("cpu"), lanes=32,
                         t0=time.monotonic())
        """))
    assert PROGRAM in loaded
    assert not loaded & NEVER


def test_the_reference_and_the_comparison_load_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.lasso, benchmark.checks.lasso, "
                           "benchmark.recipes.boston_like, benchmark.recipes.gaussian_sparse")
    assert not loaded & (NEVER | {PROGRAM})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_harness_names_jax_and_the_yardstick_names_no_program():
    harness = [p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts]
    assert harness
    for path in harness:
        names = set(_imports(path))
        assert not names & NEVER, path
        if path.parent.name in ("reference", "checks", "recipes", "metrics"):
            assert PROGRAM not in names, path


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastoptsolver_tpu_torch_probe", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fastoptsolver_tpu.probe", sys)
    assert run.forbidden_modules() == ["fastoptsolver_tpu"]
