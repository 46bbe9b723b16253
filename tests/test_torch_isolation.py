"""The PyTorch port stands alone: nothing in it, nor in ``chip_smoke.py``,
the port's scripts (``scripts/torch_*.py``) or the rank worker of its
multi-process tests (``tests/torch_mp_worker.py``), imports jax, flax, optax, orbax,
scikit-learn, TensorFlow, the JAX package, OpenCV, the image libraries the
JAX package reads through (PIL, imageio, tifffile), or the libraries under
orbax (zstandard, tensorstore, zarr, numcodecs), none of which the card's
machine has (the port reads TF checkpoints, records, event files and orbax
checkpoints with numpy, and has its own copies of the OpenCV calls and the
scikit-learn estimators); matplotlib (which it lacks too) is imported only inside the function
that draws a plot; and its CLIs run on CUDA unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "hypelcnn_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "hypelcnn_tpu",
             "PIL", "imageio", "tifffile", "tensorflow", "cv2",
             "zstandard", "tensorstore", "zarr", "numcodecs"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py"))
            + [ROOT / "tests" / "torch_mp_worker.py"])


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


def test_no_module_level_matplotlib_import():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            names = ([alias.name for alias in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(name.split(".")[0] == "matplotlib" for name in names):
                offenders.append(str(path.relative_to(ROOT)))
    assert offenders == []


def test_importing_every_module_loads_no_jax():
    modules = list(_module_names())
    assert "hypelcnn_tpu_torch.gan.wrappers.dclgan" in modules
    unwanted = sorted(FORBIDDEN | {"matplotlib"})
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            f"loaded = sorted(m for m in sys.modules if m.split('.')[0] in {unwanted!r})\n"
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


def test_train_cli_without_device_refuses_to_run_without_cuda(monkeypatch, tmp_path):
    from hypelcnn_tpu_torch.apps import train_for_classification
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_for_classification.main([
            "--loader_name=SyntheticDataLoader", "--path=synthetic://?h=8&w=8&bands=3",
            "--importer_name=GeneratorImporter", "--neighborhood=1", "--step=2",
            f"--base_log_path={tmp_path}", f"--output_path={tmp_path}"])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("app, args", [
    ("gan_train_for_shadow", ["--step=2"]),
    ("gan_infer_for_shadow", []),
    ("gan_infer_image_for_shadow", ["--make_them_shadow=shadow"]),
])
def test_gan_clis_without_device_refuse_to_run_without_cuda(monkeypatch, tmp_path, app, args):
    import importlib
    main = importlib.import_module(f"hypelcnn_tpu_torch.apps.{app}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--loader_name=SyntheticDataLoader", "--path=synthetic://?h=8&w=8&bands=3",
              f"--base_log_path={tmp_path / 'run'}", f"--output_path={tmp_path}", *args])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("module, args", [
    ("apps.classic_ml_trainer", ["--fullscene", "--hyperparamopt"]),
    ("utils.lidar_matcher", []),
    ("utils.measure_targets_shadow_ratio", ["--pairing_method=random"]),
    ("utils.nn_layer_activation_graph", ["--bands=4", "--class_count=3"]),
    ("utils.remove_test_targets_from_shadow", []),
    ("utils.reveal_shadow_targets", []),
])
def test_offline_tools_without_device_refuse_to_run_without_cuda(monkeypatch, tmp_path, module,
                                                                 args):
    import importlib
    main = importlib.import_module(f"hypelcnn_tpu_torch.{module}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--loader_name=SyntheticDataLoader", "--path=synthetic://?h=8&w=8&bands=3",
              f"--base_log_path={tmp_path / 'run'}", f"--output_path={tmp_path}", *args])
    assert not any(tmp_path.iterdir())
