"""Closed loop of full-scene sweeps: one analyst classifying whole scenes
back to back through the port's ``predict_full_scene``, as its infer CLI
does (``--domain all``); each class map comes back to the host.

Traffic parameters: ``batch_rows`` (scene rows a band), ``check_pixels``
(pixels of every map judged by the reference), ``check_block`` (windows
the reference takes at once), ``calibration_windows`` (windows whose
moments set the batch-norm statistics of the weights).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench import scene as scene_lib
from portbench.reference.common import Norms, padded_scene, precision, windows
from portbench.weights import calibrate


class Driver:
    def __init__(self, env):
        self.env = env
        self.height, self.width = env.arrays.gt.shape
        self.rows = env.traffic["batch_rows"]
        self.maps = []

    def setup(self, mark) -> None:
        from hypelcnn_tpu_torch.core.registry import get_model_from_name
        from hypelcnn_tpu_torch.data.scene import Scene
        from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene

        env = self.env
        n = env.config["neighborhood"]
        k = 2 * n + 1
        reference_scene = padded_scene(env.arrays.casi, env.arrays.lidar, n, env.device)
        xy = scene_lib.sample_pixels(self.height, self.width, env.traffic["calibration_windows"],
                                     env.sub_seed("calibration"))
        batch = windows(reference_scene, torch.from_numpy(xy), k)
        with precision(tf32=False):
            calibrate(env.model, env.weights, batch, env.weight_generator)
        del reference_scene, batch
        mark("calibration")
        self.scene = Scene(env.arrays.casi, env.arrays.lidar, n, True)
        module = get_model_from_name(env.config["model"]).create_module(
            env.config["scene"]["classes"], env.config["params"], env.data_shape)
        module.load_state_dict(env.weights)
        self.module = module.to(env.device)
        self._predict = predict_full_scene
        mark("program")
        # every band of a sweep has one shape, so a scene of one band warms them all
        band = slice(0, self.rows)
        warm = Scene(env.arrays.casi[band], env.arrays.lidar[band], n, True)
        self._predict(self.module, warm, batch_rows=self.rows, device=env.device)
        mark("warm-up")

    def _sweep(self) -> np.ndarray:
        with record_function("portbench.scene"):
            return self._predict(self.module, self.scene, batch_rows=self.rows,
                                 device=self.env.device)

    def window(self, seconds: float):
        if self.env.device.type == "cuda":
            torch.cuda.synchronize(self.env.device)
        start = time.perf_counter()
        maps = []
        while True:
            maps.append(self._sweep())  # the map is on the host: the scene is done
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        self.maps += maps
        pixels = len(maps) * self.height * self.width
        classes = self.env.config["scene"]["classes"]
        failed = sum(m.shape != (self.height, self.width) or int(m.max()) >= classes
                     for m in maps)
        return SimpleNamespace(metrics={"sweep_pixels_per_s": pixels / elapsed},
                               units=pixels, seconds=elapsed, iterations=len(maps),
                               attempted=len(maps), failed=failed)

    def stretch(self):
        self._sweep()
        return self.height * self.width, 1

    def release(self) -> None:
        del self.module, self.scene

    # ---- the judgement ----

    def reference_logits(self, xy: np.ndarray, tf32: bool = False) -> torch.Tensor:
        """The reference's logits at pixels ``xy``, in blocks."""
        env = self.env
        n = env.config["neighborhood"]
        scene = padded_scene(env.arrays.casi, env.arrays.lidar, n, env.device)
        block = env.traffic["check_block"]
        out = []
        with torch.no_grad(), precision(tf32):
            for start in range(0, xy.shape[0], block):
                x = windows(scene, torch.from_numpy(xy[start:start + block]), 2 * n + 1)
                out.append(env.model.forward(env.weights, x, Norms("running"))[0])
        return torch.cat(out).double()

    def class_gap(self, logits: torch.Tensor, xy: np.ndarray, maps) -> float:
        """The widest gap, over ``maps`` at ``xy``, by which the logit of the
        class the map gives lies below the reference's best, as a share of
        the largest logit magnitude."""
        best = logits.max(dim=1).values
        scale = logits.abs().max().item()
        gap = 0.0
        for m in maps:
            ids = torch.from_numpy(m[xy[:, 1], xy[:, 0]].astype(np.int64)).to(logits.device)
            chosen = logits.gather(1, ids.clamp(max=logits.shape[1] - 1)[:, None])[:, 0]
            gap = max(gap, (best - chosen).max().item())
        return gap / scale

    def sample(self) -> np.ndarray:
        return scene_lib.sample_pixels(self.height, self.width, self.env.traffic["check_pixels"],
                                       self.env.sub_seed("check"))

    def check(self) -> dict:
        xy = self.sample()
        self.logits = self.reference_logits(xy)
        return {"class_gap": self.class_gap(self.logits, xy, self.maps)}

    def control_readings(self) -> dict:
        """After :meth:`check`: the numbers compared where the TF32
        reference takes the program's place, and where an answer of the
        window's last map is altered (the first band's ids moved up by one)
        or half of each band is left out (its ids left at 0)."""
        xy = self.sample()
        classes = self.env.config["scene"]["classes"]
        control = np.zeros((self.height, self.width), dtype=np.uint8)
        picked = self.reference_logits(xy, tf32=True).argmax(dim=1).cpu().numpy()
        control[xy[:, 1], xy[:, 0]] = picked
        altered = self.maps[-1].copy()
        altered[:self.rows] = (altered[:self.rows] + 1) % classes
        half = self.maps[-1].copy().reshape(-1)
        band = self.rows * self.width
        for start in range(0, half.size, band):
            half[start + band // 2:start + band] = 0
        return {name: {"class_gap": self.class_gap(self.logits, xy, [m])}
                for name, m in (("control_tf32", control), ("answer_altered", altered),
                                ("half_band_left_out", half.reshape(altered.shape)))}
