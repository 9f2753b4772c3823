"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under perfbench/, and nothing of the program under test in the
plain reference. Top-level module names are compared whole: the port's
name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ldpc_sparc_tpu"}
PROGRAM = "ldpc_sparc_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in `path`; relative imports
    stay inside perfbench/."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_scan_sees_whole_names():
    src = "import ldpc_sparc_tpu_torch\nfrom ldpc_sparc_tpu.ops import x\nimport jax.numpy\n"
    tree = Path(BENCH / "tests" / "_scan_probe.py")
    try:
        tree.write_text(src)
        assert top_level_imports(tree) == {"ldpc_sparc_tpu_torch", "ldpc_sparc_tpu", "jax"}
    finally:
        tree.unlink()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert not top_level_imports(path) & {"perfbench"}


def test_a_run_loads_no_jax():
    """Import the harness, every driver and the program's Monte Carlo in a
    fresh interpreter; sys.modules then holds no forbidden top-level name."""
    code = ("import sys, importlib, pathlib\n"
            "import perfbench.run, perfbench.calibrate\n"
            "for p in pathlib.Path('perfbench/drivers').glob('*.py'):\n"
            "    importlib.import_module('perfbench.drivers.' + p.stem)\n"
            "import ldpc_sparc_tpu_torch.parallel.montecarlo\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not set(eval(out.stdout.strip().splitlines()[-1])) & FORBIDDEN


def test_without_a_card_the_run_fails_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                          "sparc_flagship.deep_6db", "--seed", "2147483700",
                          "--seconds", "1", "--trace", "0"], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              **{k: v for k, v in __import__("os").environ.items()
                                 if k in ("HOME", "PYTHONPATH", "TMPDIR")}})
    assert out.returncode != 0 and out.stdout == ""
