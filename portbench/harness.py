"""The benchmark's harness: one run of one cell, found by name.

Everything that belongs to one configuration, traffic mix or metric sits in
files of its own under this folder, found from ``BENCHMARK.json``:

- ``configs/<config>.json``, the configuration as it is run, names its
  plain reference ``reference/<reference>.py`` (a ``Model`` class);
- ``traffic/<traffic>.json``, a mix's parameters, names its driver
  ``drivers/<driver>.py`` (a ``Driver`` class);
- ``metrics/<metric>.py``, a per-layer metric's reader (``read(ctx)``,
  which returns the number or None where it finds nothing to read);
- ``limits/<workload>.json``, the limit of each number that decides
  ``correct`` in that cell.

A run: set-up (the scene and the weights made from the seed, the program
built and every shape of the cell warmed up), then the measured window,
then with ``--trace 1`` a traced stretch of the same work, then the
program's state freed and its outputs judged by the plain reference.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from portbench import scene as scene_lib
from portbench import trace as trace_lib
from portbench import weights as weights_lib

HARNESS = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hypelcnn_tpu")


def sub_seed(seed: int, purpose: str, bits: int = 63) -> int:
    """A seed for one purpose, from the run's ``--seed``."""
    digest = hashlib.blake2s(f"{seed}/{purpose}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << bits) - 1)


def load_file(path: Path, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fid:
        return json.load(fid)


def _for_cell(entries: list, workload: str, metric_names: Optional[set] = None) -> list:
    """The metrics of ``entries`` that ``workload`` reports."""
    return [m for m in entries if workload in m.get("workloads", [workload])
            and (metric_names is None or m.get("moves") in metric_names)]


class Cell:
    """Everything of one workload, found from ``root/BENCHMARK.json``."""

    def __init__(self, root: Path, workload: str, overrides: Optional[dict] = None):
        self.root = Path(root)
        self.harness = self.root / HARNESS.name
        bench = _read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
        self.workload = cells[workload]
        config_entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = _read_json(self.root / config_entry["file"])
        self.traffic = _read_json(self.harness / "traffic" / f"{self.workload['traffic']}.json")
        for key, value in (overrides or {}).items():  # small sizes, for the CPU tests only
            target = self.config if key in ("params", "scene") else self.traffic
            target[key] = {**target[key], **value} if isinstance(value, dict) else value
        self.limits = _read_json(self.harness / "limits" / f"{workload}.json")
        self.end_to_end = _for_cell(bench["end_to_end"], workload)
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = _for_cell(bench["per_layer"], workload, names)
        reference = load_file(self.harness / "reference" / f"{self.config['reference']}.py",
                              f"portbench_reference_{self.config['reference']}")
        scene = self.config["scene"]
        k = 2 * self.config["neighborhood"] + 1
        self.data_shape = [k, k, scene["casi_bands"] + 1]
        self.model = reference.Model(self.config["params"], scene["classes"], self.data_shape)
        self.driver_module = load_file(self.harness / "drivers" / f"{self.traffic['driver']}.py",
                                       f"portbench_driver_{self.traffic['driver']}")

    def reader(self, metric: str):
        return load_file(self.harness / "metrics" / f"{metric}.py",
                         "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             overrides: Optional[dict] = None, after_check=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``t0`` is the process's start on the host clock (``setup_s`` counts from
    it). ``after_check(driver, env)`` runs after the judgement (the
    readings tool's control and faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": time.perf_counter() - t0}
    from hypelcnn_tpu_torch.core.platform import resolve_device  # the port's float32 policy

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    phases["device"] = time.perf_counter() - t0
    cell = Cell(root, workload, overrides)
    spec = cell.config["scene"]
    arrays = scene_lib.make_scene(spec, sub_seed(seed, "scene"))
    phases["scene"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "weights"))
    weights = weights_lib.make_weights(cell.model, gen, dev)
    phases["weights"] = time.perf_counter() - t0
    env = SimpleNamespace(config=cell.config, traffic=cell.traffic, model=cell.model,
                          data_shape=cell.data_shape, arrays=arrays, weights=weights,
                          weight_generator=gen, device=dev,
                          sub_seed=lambda purpose, bits=63: sub_seed(seed, purpose, bits))
    driver = cell.driver_module.Driver(env)
    driver.setup(lambda name: phases.__setitem__(name, time.perf_counter() - t0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    print("setup phases (s from the start): " + json.dumps(phases), file=sys.stderr)

    window = driver.window(seconds)
    record = device_record(dev)
    values = {**window.metrics, "setup_s": setup_s}
    ctx = SimpleNamespace(cell=cell, model=cell.model, config=cell.config, traffic=cell.traffic,
                          window=window, trace=None, device_kind=record["kind"])
    if trace:
        ctx.trace = trace_lib.traced_stretch(driver.stretch, dev)
        if ctx.trace is not None:
            record["busy_s"] = ctx.trace.busy_s
            record["window_s"] = ctx.trace.window_s
        chosen = cell.per_layer
    else:
        chosen = cell.end_to_end
    metrics = {}
    for m in chosen:
        value = values[m["name"]] if not trace else cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check()
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in readings.items()}
    correct = window.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    if after_check is not None:
        after_check(driver, env)
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": record}
    if trace and ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = HARNESS.parent
    bench = _read_json(root / "BENCHMARK.json")
    chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the port must run without JAX "
              "and without the JAX package", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
