"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or the JAX package, and an entry point asked
for the default device without a CUDA device raises instead of running on
the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path) if _foreign(name)]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_of_the_reference_has_its_port():
    """The module diff of the two packages is empty: every module of
    ``src/repro`` has a namesake in ``src/repro_torch``, but for the Pallas
    kernels, whose kernel and reference modules are a CUDA source under
    ``kernels/csrc`` and the plain versions in the kernel's ``ops.py``."""
    ref = ROOT / "src" / "repro"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref)
        if rel.parts[0] == "kernels" and len(rel.parts) == 3 and rel.stem in (rel.parts[1], "ref"):
            kernel = PORT / "kernels" / rel.parts[1]
            if not (kernel / "ops.py").exists() or not list((PORT / "kernels" / "csrc").glob("*.cu")):
                missing.append(str(rel))
        elif not (PORT / rel).exists():
            missing.append(str(rel))
    assert not missing, missing


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    from repro_torch.config import resolve_device
    from repro_torch.core import threefry
    from repro_torch.data.healthlnk import generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.interop import tables_from_numpy
    from repro_torch.launch import train as launch_train
    from repro_torch.ops import SecretTable
    from repro_torch.train import Checkpointer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"a": np.arange(4, dtype=np.uint32)}
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, {"params": {"w": torch.ones(2)}})
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: SecretTable.from_plaintext(data, threefry.PRNGKey(0)),
        lambda: Engine({}),
        lambda: generate_healthlnk(n=8),
        lambda: tables_from_numpy({"t": ({"a": np.zeros((3, 4), np.uint32)}, np.zeros((3, 4), np.uint32))}),
        lambda: launch_train.main(["--reduced", "--steps", "1"]),
        lambda: ckpt.restore(None, {"params": {"w": torch.empty(2, device="meta")}}),
        lambda: ckpt.restore(None, {"params": {"w": torch.ones(2)}}, device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # asking for the CPU is the only way onto it
    table = SecretTable.from_plaintext(data, threefry.PRNGKey(0), device="cpu")
    assert table.device.type == "cpu"
    assert Engine({"t": table}, device="cpu").device.type == "cpu"
    assert ckpt.restore(None, {"params": {"w": torch.empty(2, device="meta")}}, device="cpu")[1]["params"]["w"].sum() == 2
    with pytest.raises(ValueError):
        Engine({"t": table}, device="meta")
