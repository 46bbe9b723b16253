"""Closed loop of full-scene sweeps, as ``sweep`` runs them, for a model
whose evaluation couples the windows of a batch (CAP: batch norm with the
batch's moments, routing agreement summed over the batch). A pixel's class
then depends on the other windows of its band, so the judgement classifies
whole bands, each as one batch, as the program batches them.

Traffic parameters: ``batch_rows`` (scene rows a band), ``check_bands``
(bands judged, drawn from the seed; the last band, moved up to end at the
last row so that it overlaps the band before, always among them).

The judgement reads ``class_gap`` (as ``sweep`` does) over every pixel of
every map whose final owner is a checked band, in two sets. Routing sums its
agreement over the band, so each capsule's couplings are one-hot to float32;
where a capsule's two largest logits of the last round nearly tie, float32's
own rounding of those sums decides its coupling, and two float32 orders of
the same sums part by up to 7e-4 there. So bands with such a tie are read
apart, as ``class_gap_near_tie``, under a limit of their own.

Set-up makes the capsule network's weights in place: each input capsule's
transform Glorot-uniform with its own fans (fan-in ``P``, fan-out ``J*C``;
``weights.make_weights`` reckons a 3-D tensor's fans as a convolution's),
and every batch norm's bias from N(0, 0.1^2), as ``weights.calibrate`` draws
them. Running statistics stay unused: CAP normalizes with the batch's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.drivers.sweep import Driver as SweepDriver
from portbench.reference.common import Norms, padded_scene, precision, windows

# a routing tie nearer than this share of the largest logit decides a coupling by
# rounding: the logits' own float32 error reaches 1.4e-4 of it (PERF.md §2)
NEAR_TIE = 5e-4


class Driver(SweepDriver):
    def setup(self, mark) -> None:
        from hypelcnn_tpu_torch.core.registry import get_model_from_name
        from hypelcnn_tpu_torch.data.scene import Scene
        from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene

        env = self.env
        capsule_weights(env.weights, env.weight_generator)
        mark("weights")
        n = env.config["neighborhood"]
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

    # ---- the judgement ----

    def band_starts(self) -> list:
        """The first row of each band, as ``predict_full_scene`` walks them."""
        count = -(-self.height // self.rows)
        return [min(index * self.rows, self.height - self.rows) for index in range(count)]

    def checked_bands(self) -> list:
        """``check_bands`` band indices drawn from the seed, the last among them."""
        count = len(self.band_starts())
        rng = np.random.default_rng(self.env.sub_seed("check"))
        drawn = rng.choice(count - 1, size=self.env.traffic["check_bands"] - 1, replace=False)
        return sorted(int(i) for i in drawn) + [count - 1]

    def owned_rows(self, index: int) -> range:
        """The rows whose final ids band ``index`` writes: a later band that
        overlaps it overwrites its last rows."""
        starts = self.band_starts()
        stop = starts[index + 1] if index + 1 < len(starts) else self.height
        return range(starts[index], min(stop, starts[index] + self.rows))

    def sample(self) -> np.ndarray:
        """``[N, 2]`` (x, y) of every pixel that the checked bands own, band by band."""
        rows = np.concatenate([np.array(self.owned_rows(i)) for i in self.checked_bands()])
        return np.stack([np.tile(np.arange(self.width), rows.size),
                         np.repeat(rows, self.width)], axis=1)

    def band_scores(self, tf32: bool = False):
        """The reference's class scores at the pixels of :meth:`sample`, each
        checked band classified whole as one batch in the program's order,
        and whether each pixel's band has a near tie in its routing."""
        env = self.env
        n = env.config["neighborhood"]
        scene = padded_scene(env.arrays.casi, env.arrays.lidar, n, env.device)
        cols = torch.arange(self.width)
        scores, near = [], []
        with torch.no_grad(), precision(tf32):
            for index in self.checked_bands():
                start = self.band_starts()[index]
                rows = torch.arange(start, start + self.rows)
                band = torch.stack([cols.repeat(self.rows), rows.repeat_interleave(self.width)], 1)
                record = {}
                out, _ = env.model.forward(env.weights, windows(scene, band, 2 * n + 1),
                                           Norms("batch", record))
                owned = len(self.owned_rows(index)) * self.width
                scores.append(out[:owned])
                near.append(torch.full((owned,), near_tie(record["routing_logits"])))
        return torch.cat(scores).double(), torch.cat(near).numpy()

    def readings(self, maps) -> dict:
        """``class_gap`` over the pixels of bands without a near tie in their
        routing, ``class_gap_near_tie`` over the others (0 where a set is empty)."""
        xy = self.sample()
        return {name: self.class_gap(self.logits[torch.from_numpy(mask)], xy[mask], maps)
                if mask.any() else 0.0
                for name, mask in (("class_gap", ~self.near), ("class_gap_near_tie", self.near))}

    def check(self) -> dict:
        self.logits, self.near = self.band_scores()
        return self.readings(self.maps)

    def control_readings(self) -> dict:
        """After :meth:`check`: the numbers compared where the TF32 reference,
        band by band, takes the program's place, and where an answer of the
        window's last map is altered (the first checked band's ids moved up
        by one) or half of each band is left out (its ids left at 0)."""
        xy = self.sample()
        classes = self.env.config["scene"]["classes"]
        control = np.zeros((self.height, self.width), dtype=np.uint8)
        control[xy[:, 1], xy[:, 0]] = self.band_scores(tf32=True)[0].argmax(1).cpu().numpy()
        altered = self.maps[-1].copy()
        first = self.owned_rows(self.checked_bands()[0])
        altered[first.start:first.stop] = (altered[first.start:first.stop] + 1) % classes
        half = self.maps[-1].copy()
        for start in self.band_starts():
            band = half[start:start + self.rows].reshape(-1)
            band[band.size // 2:] = 0
        return {name: self.readings([m]) for name, m in (
            ("control_tf32", control), ("answer_altered", altered), ("half_band_left_out", half))}


def near_tie(logits: torch.Tensor) -> bool:
    """Whether some capsule's two largest routing logits of the last round lie
    closer than ``NEAR_TIE`` of the largest logit magnitude: its coupling is
    then decided by float32's rounding of the agreement sums."""
    top = torch.topk(logits, 2, dim=1).values
    return bool(((top[:, 0] - top[:, 1]) < NEAR_TIE * logits.abs().max()).any())


@torch.no_grad()
def capsule_weights(weights: dict, generator: torch.Generator) -> None:
    """The transform Glorot-uniform per input capsule and random batch-norm
    biases, in place."""
    transform = weights["digitcaps_w"]
    fan_in, fan_out = transform.shape[1:]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    transform.uniform_(-bound, bound, generator=generator)
    biases = [name for name in weights if name.endswith("BatchNorm_0.bias")]
    sizes = [weights[name].numel() for name in biases]
    draws = 0.1 * torch.randn(sum(sizes), generator=generator, device=transform.device)
    for name, part in zip(biases, torch.split(draws, sizes)):
        weights[name].copy_(part)
