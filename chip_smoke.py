#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result,
without them. Phases, one JSON line each:

1. ``device``: the card's name and power limit.
2. ``build``: every kernel source built with ``nvcc`` (in parallel).
3. ``kernel_vs_plain``: the CUDA window gather held bit for bit against its
   plain PyTorch version, k in {1, 3, 5, 7, 9}, C in {12, 145},
   B in {1, 129, 30480}, with out-of-range and negative coordinates.
4. ``infer_all``: ``infer_for_classification --domain=all --device=cuda`` at
   the full width of ``configs/modelconfigs/alg_param_hypelcnn.json`` over a
   GRSS2013-size synthetic scene (349 x 1905, 144 bands plus LiDAR, 15
   classes), random weights from a seed. The gather's launch count over that
   run must equal the band count; the class map must equal the sweep's with
   the plain gather; float32 logits on the card must agree with the CPU's on
   a small batch. Then the sweep is timed.
5. ``kernels``: each kernel's time at the main path's shapes beside its
   plain version, one PyTorch library call and its bound.
6. ``profile``: device time by kernel over one traced sweep, and the
   device's idle share.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from hypelcnn_tpu_torch.apps import infer_for_classification
from hypelcnn_tpu_torch.core.config import load_algorithm_params
from hypelcnn_tpu_torch.core.platform import resolve_device
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene
from hypelcnn_tpu_torch.kernels import build
from hypelcnn_tpu_torch.kernels.window_gather import window_gather_cuda
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.models.layers import SlimBatchNorm, SlimConv, init_parameters
from hypelcnn_tpu_torch.ops.window_gather import gather_patches_torch
from hypelcnn_tpu_torch.train.checkpoint import save_checkpoint
from hypelcnn_tpu_torch.utils.tiff_io import read_tags

ROOT = Path(__file__).resolve().parent
SOURCES = ["window_gather"]
SPEC = "synthetic://?h=349&w=1905&bands=144&classes=15"
HEIGHT, WIDTH, CLASSES, NEIGHBORHOOD = 349, 1905, 15, 1
BATCH_ROWS = 16
PARAMS_PATH = ROOT / "configs" / "modelconfigs" / "alg_param_hypelcnn.json"
SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, same sheet


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})
    return name


def phase_build() -> None:
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(build.build, SOURCES))
    for name in SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - start,
          "libraries": [str(p.relative_to(ROOT)) for p in paths]})


def phase_kernel_vs_plain(device) -> None:
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = 0
    for channels in (12, 145):
        hp, wp = 40, 300
        scene = torch.randn((hp, wp, channels), generator=gen, device=device)
        for k in (1, 3, 5, 7, 9):
            for batch in (1, 129, 30480):
                xs = torch.randint(0, wp - k + 1, (batch,), generator=gen, device=device)
                ys = torch.randint(0, hp - k + 1, (batch,), generator=gen, device=device)
                wild = torch.rand((batch,), generator=gen, device=device) < 0.25
                xs = torch.where(wild, torch.randint(-2 * wp, 2 * wp, (batch,), generator=gen,
                                                     device=device), xs)
                ys = torch.where(wild, torch.randint(-2 * hp, 2 * hp, (batch,), generator=gen,
                                                     device=device), ys)
                coords = torch.stack([xs, ys], dim=1).to(torch.int32).contiguous()
                coords[0] = torch.tensor([-1, -k], dtype=torch.int32)
                got = window_gather_cuda(scene, coords, k)
                torch.cuda.synchronize()
                check(torch.equal(got, gather_patches_torch(scene, coords, k)),
                      f"window_gather differs from its plain version at k={k}, "
                      f"C={channels}, B={batch}")
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": 0.0, "exact": True})


def _random_module(params, data_shape, patches: torch.Tensor):
    """HYPELCNN at full width with random weights from one seeded generator.

    The batch-norm running statistics come from one train-mode pass over
    ``patches`` (dropout off, momentum 0, so they are those patches' batch
    statistics), and the batch-norm biases are then drawn at random. Zero
    means and unit variances would leave every pixel in one class.
    """
    module = HYPELCNNModel().create_module(CLASSES, params, data_shape)
    gen = torch.Generator().manual_seed(SEED)
    init_parameters(module, gen)
    norms = [layer for layer in module.modules() if isinstance(layer, SlimBatchNorm)]
    momenta = [bn.momentum for bn in norms]
    for bn in norms:
        bn.momentum = 0.0
    module.train()
    module.dropout.eval()
    with torch.no_grad():
        module(patches)
        for bn, momentum in zip(norms, momenta):
            bn.momentum = momentum
            bn.bias.copy_(0.1 * torch.randn(bn.bias.shape[0], generator=gen))
    return module.eval()


def _timed_sweeps(fn, runs: int = 3) -> list:
    fn()  # warm-up
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return times


def _read_tiff_strip(path: Path, shape) -> np.ndarray:
    tags = read_tags(str(path))
    with open(path, "rb") as fid:
        fid.seek(tags[273])
        return np.frombuffer(fid.read(tags[279]), dtype=np.uint8).reshape(shape)


def phase_infer_all(device, work: Path):
    params = load_algorithm_params(HYPELCNNModel().default_params(), str(PARAMS_PATH))
    scene = SyntheticDataLoader(SPEC).load_data(NEIGHBORHOOD, True)
    data_shape = scene.get_data_shape()
    rng = np.random.default_rng(SEED)
    calibration = torch.from_numpy(np.stack([rng.integers(0, WIDTH, 2048),
                                             rng.integers(0, HEIGHT, 2048)], axis=1).astype(np.int32))
    module = _random_module(params, data_shape, gather_patches_torch(
        scene.device_scene("cpu"), calibration, data_shape[0]))
    log_dir, out_dir = work / "log", work / "out"
    save_checkpoint(str(log_dir), 1, module.state_dict())
    n_bands = (HEIGHT + BATCH_ROWS - 1) // BATCH_ROWS

    torch.cuda.reset_peak_memory_stats()
    window_gather_cuda.launches = 0
    start = time.perf_counter()
    infer_for_classification.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", f"--neighborhood={NEIGHBORHOOD}",
        f"--algorithm_param_path={PARAMS_PATH}", f"--base_log_path={log_dir}",
        f"--output_path={out_dir}", "--domain=all", "--device=cuda"])
    cli_seconds = time.perf_counter() - start
    launches = window_gather_cuda.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    check(launches == n_bands,
          f"window_gather launched {launches} times over the sweep, expected {n_bands}")

    raw, colorized = out_dir / "result_raw.tif", out_dir / "result_colorized.tif"
    check(raw.is_file() and colorized.is_file(), "the CLI did not write both TIFFs")
    check(read_tags(str(raw))[279] == HEIGHT * WIDTH, "result_raw.tif strip size")
    check(read_tags(str(colorized))[279] == HEIGHT * WIDTH * 3, "result_colorized.tif strip size")
    cli_map = _read_tiff_strip(raw, (HEIGHT, WIDTH))

    module = module.to(device)
    kernel_map = predict_full_scene(module, scene, device=device)
    plain_map = predict_full_scene(module, scene, device=device, gather=gather_patches_torch)
    check(np.array_equal(kernel_map, plain_map),
          "class maps differ between the CUDA gather and the plain gather")
    check(np.array_equal(kernel_map, cli_map), "the CLI's class map differs from the sweep's")
    classes_in_map = len(np.unique(kernel_map))
    check(int(kernel_map.max()) < CLASSES, "class ids out of range")
    check(classes_in_map > 1, "every pixel fell in one class")

    # float32 logits on the card against the CPU on a small batch
    coords = torch.from_numpy(np.stack([rng.integers(0, WIDTH, 256), rng.integers(0, HEIGHT, 256)],
                                       axis=1).astype(np.int32))
    scene_cpu = scene.device_scene("cpu")
    patches = gather_patches_torch(scene_cpu, coords, 2 * NEIGHBORHOOD + 1)
    with torch.inference_mode():
        gpu_logits = module(patches.to(device)).y_conv.cpu()
        cpu_logits = module.to("cpu")(patches).y_conv
    module.to(device)
    check(bool(torch.isfinite(gpu_logits).all()), "non-finite logits on the card")
    logit_err = float((gpu_logits - cpu_logits).abs().max() / cpu_logits.abs().max().clamp(min=1))
    check(logit_err < 1e-4, f"card and CPU logits differ by {logit_err} (relative)")

    sweep = _timed_sweeps(lambda: predict_full_scene(module, scene, device=device))
    plain_sweep = _timed_sweeps(lambda: predict_full_scene(module, scene, device=device,
                                                          gather=gather_patches_torch))
    seconds = statistics.median(sweep)
    # multiply-adds per pixel of the eval forward: each convolution at each of
    # the k x k window positions (SAME-padded taps counted), then the FC pyramid
    k = data_shape[0]
    macs = (sum(m.Conv_0.weight.numel() for m in module.modules() if isinstance(m, SlimConv)) * k * k
            + sum(m.Dense_0.weight.numel() for m in (*module.fc_stages, module.fc_final)))
    sweep_flop = 2 * macs * HEIGHT * WIDTH
    emit({"phase": "infer_all", "scene": [HEIGHT, WIDTH, data_shape[2]], "patch": data_shape[0],
          "bands": n_bands, "windows": HEIGHT * WIDTH, "gather_launches": launches,
          "cli_seconds": cli_seconds, "sweep_seconds": seconds, "sweep_runs": sweep,
          "pixels_per_second": HEIGHT * WIDTH / seconds,
          "plain_gather_sweep_seconds": statistics.median(plain_sweep),
          "flop_per_pixel": 2 * macs, "sweep_bound_seconds": sweep_flop / FP32_FLOP_PER_S,
          "classes_in_map": classes_in_map, "logit_rel_err_vs_cpu": logit_err,
          "peak_device_bytes": peak_bytes,
          "parameters": sum(p.numel() for p in module.parameters())})
    return scene, module, launches


def _event_times(fn, inputs) -> list:
    """Per-call device time in ms, from CUDA events around each call."""
    fn(inputs[0])
    times = []
    for item in inputs:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(item)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in times]


def phase_kernels(device, scene, launches: int) -> None:
    scene_dev = scene.device_scene(device)
    k = 2 * NEIGHBORHOOD + 1
    hp, wp, channels = scene_dev.shape
    n_bands = (HEIGHT + BATCH_ROWS - 1) // BATCH_ROWS
    rows = torch.arange(BATCH_ROWS, device=device, dtype=torch.int32)
    cols = torch.arange(WIDTH, device=device, dtype=torch.int32)
    band = torch.stack([cols.repeat(BATCH_ROWS), rows.repeat_interleave(WIDTH)], dim=1)
    # 20 consecutive bands, so each call reads scene rows the last one did not
    bands = [band.add(torch.tensor([0, 1], dtype=torch.int32, device=device),
                      alpha=min(i * BATCH_ROWS, HEIGHT - BATCH_ROWS)) for i in range(20)]
    # in-range indices for the library call: every band lies inside the padded scene
    offs = torch.arange(k, device=device)
    index_pairs = [((c[:, 1, None] + offs)[:, :, None], (c[:, 0, None] + offs)[:, None, :])
                   for c in bands]
    batch = bands[0].shape[0]

    before = window_gather_cuda.launches
    err = 0.0
    for coords in bands[:n_bands]:
        err = max(err, float((window_gather_cuda(scene_dev, coords, k)
                              - gather_patches_torch(scene_dev, coords, k)).abs().max()))
    torch.cuda.synchronize()
    ms = statistics.median(_event_times(lambda c: window_gather_cuda(scene_dev, c, k), bands))
    plain_ms = statistics.median(_event_times(lambda c: gather_patches_torch(scene_dev, c, k),
                                              bands))
    library_ms = statistics.median(_event_times(lambda yx: scene_dev[yx[0], yx[1]], index_pairs))
    window_gather_cuda.launches = before

    # bytes the function must move for one band: each output float written
    # once, each distinct scene pixel it reads read once, the coordinates read once
    ys, xs = index_pairs[0]
    distinct_pixels = int(torch.unique((ys * wp + xs).reshape(-1)).numel())
    out_bytes = batch * k * k * channels * 4
    read_bytes = distinct_pixels * channels * 4 + batch * 2 * 4
    bound_ms = (out_bytes + read_bytes) / HBM_BYTES_PER_S * 1e3
    check(err == 0.0, f"window_gather differs from its plain version at the band shape: {err}")
    emit({"kernels": [{
        "name": "window_gather", "route": "cuda",
        "source": "hypelcnn_tpu_torch/csrc/window_gather.cu",
        "replaces": "hypelcnn_tpu/ops/window_gather.py:183",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
        "shape": f"{batch}x{k}x{k}x{channels} f32",
        "bytes_written": out_bytes, "bytes_read": read_bytes}]})


def phase_profile(device, scene, module) -> None:
    """Device time by kernel over one full-scene sweep (``torch.profiler``).
    Tracing slows the host several times over, so the idle share compares
    the traced device time with an untraced sweep just before it."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    untraced_ms = statistics.median(_timed_sweeps(
        lambda: predict_full_scene(module, scene, device=device), runs=1)) * 1e3
    with torch.profiler.profile(activities=activities) as prof:
        predict_full_scene(module, scene, device=device)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda row: -row[1])
    busy_ms = sum(row[1] for row in rows)
    emit({"phase": "profile", "untraced_sweep_ms": untraced_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1 - busy_ms / untraced_ms),
          "top": [{"name": name[:120], "ms": ms, "calls": count} for name, ms, count in rows[:20]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    name = phase_device()
    phase_build()
    phase_kernel_vs_plain(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        scene, module, launches = phase_infer_all(device, Path(work))
    phase_kernels(device, scene, launches)
    phase_profile(device, scene, module)
    torch.cuda.synchronize()
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
