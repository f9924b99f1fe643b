"""Nothing the benchmark runs imports JAX or the JAX package ``repro`` (top-
level module names compared whole: the port ``repro_torch`` begins with
``repro``), nothing reads ``benchmarks/``, the plain reference imports
nothing of the program, and the command refuses to run without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(where: Path):
    return [p for p in sorted(where.rglob("*.py")) if not p.name.startswith("test_")]


def test_no_file_imports_jax_or_the_jax_package():
    for p in sorted(BENCH.rglob("*.py")):
        assert not _imports(p) & FORBIDDEN, p


def test_no_launcher_names_a_module_of_the_jax_package():
    from chipbench.harness import spec

    for name, module in spec.kernel_costs().items():
        assert module.LAUNCHER[0].split(".")[0] == "repro_torch", name


def test_nothing_reads_benchmarks():
    for p in _sources(BENCH):
        strings = [n.value for n in ast.walk(ast.parse(p.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        assert not any("benchmarks/" in s or s == "benchmarks" for s in strings), p


def test_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").rglob("*.py")):
        assert _imports(p) <= {"__future__", "typing", "numpy"}, (p, _imports(p))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_the_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "paper_joins", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's own files
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "paper_joins", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "the program (src/repro_torch) is not in" in proc.stderr


RUN_ON_CPU = """
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
from chipbench.harness.cell import run_cell
from chipbench.harness.spec import load_cell
from chipbench.run import forbidden_modules
for name in ("paper_joins", "service_dashboard"):
    cell = load_cell(name)
    data = dict(cell.config["data"], rows=48, patients=12)
    out, _ = run_cell(cell, 2**31 + 5, 0.0, True, torch.device("cpu"), time.perf_counter(), data=data)
    assert out["correct"], out
print(json.dumps(forbidden_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", RUN_ON_CPU, str(ROOT)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
