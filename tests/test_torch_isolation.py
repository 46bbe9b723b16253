"""The PyTorch port stands alone: nothing in it, nor in ``chip_smoke.py``,
imports jax, flax, optax, orbax or the JAX package, and its CLI runs on
CUDA unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "hypelcnn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "hypelcnn_tpu"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 20
    offenders = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
                 for p in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_every_module_loads_no_jax():
    modules = list(_module_names())
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            f"loaded = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "print(len(sys.modules), loaded)\n"
            "sys.exit(1 if loaded else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_without_device_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    from hypelcnn_tpu_torch.apps import infer_for_classification
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_for_classification.main([
            "--loader_name=SyntheticDataLoader", "--path=synthetic://?h=8&w=8&bands=3",
            f"--base_log_path={tmp_path}", f"--output_path={tmp_path}", "--domain=all"])
    assert not any(tmp_path.iterdir())
