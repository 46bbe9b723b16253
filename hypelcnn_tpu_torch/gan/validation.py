"""GAN validation: band-ratio statistics and JS divergence
(``hypelcnn_tpu/gan/validation.py``, copied: numpy only).

- The per-band ratio of generated to original samples, scaled by the
  physical shadow ratio, with non-finite samples dropped;
- divergence ``|JS(|mean - 1|, 0)|`` for the mean and for the mean + std;
- :class:`BestRatioHolder` keeps the best 10 (iteration, divergence)
  points, saved as JSON;
- percentile band-ratio plots, where matplotlib is installed (it is
  imported only to draw one; without it one line names the plot that was
  not written);
- peer validation runs the shadow and de-shadow directions and reports the
  iterations in both best lists.

:func:`load_samples_for_testing` draws its pixels from Python's unseeded
``random`` module, as the JAX package does.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from hypelcnn_tpu_torch.utils.plotting import pyplot


def adj_shadow_ratio(shadow_ratio: np.ndarray, is_shadow: bool) -> np.ndarray:
    return 1.0 / shadow_ratio if is_shadow else shadow_ratio


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    safe_p = np.where(p != 0, p, 1.0)
    safe_q = np.where(q != 0, q, 1.0)
    return float(np.sum(np.where(p != 0, p * np.log(safe_p / safe_q), 0)))


def js_divergence(p: np.ndarray, q: np.ndarray) -> float:
    m = 0.5 * (p + q)
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def divergence_for_ratios(mean_val: np.ndarray) -> float:
    return abs(js_divergence(np.abs(mean_val - 1), np.zeros_like(mean_val)))


class BestRatioHolder:
    """Sorted top-N (iteration, divergence) with JSON persistence."""

    def __init__(self, max_size: int) -> None:
        self.data_holder: List[Tuple[int, float]] = []
        self.max_size = max_size

    def add_point(self, iteration: int, diver_val: float) -> None:
        iteration, diver_val = int(iteration), float(diver_val)
        insert_idx = sum(1 for (_, d) in self.data_holder if diver_val > d)
        self.data_holder.insert(insert_idx, (iteration, diver_val))
        if len(self.data_holder) > self.max_size:
            self.data_holder.pop()

    def get_best_diver(self) -> Optional[float]:
        return self.data_holder[0][1] if self.data_holder else None

    def get_point_with_itr(self, iteration: int):
        for (curr_iter, curr_diver) in self.data_holder:
            if curr_iter == iteration:
                return curr_iter, curr_diver
        return None, None

    def load(self, file_address: str) -> None:
        try:
            with open(file_address, "r", encoding="utf-8") as fid:
                self.data_holder = [tuple(p) for p in json.load(fid)]
            print(f"Best ratio file {file_address} is loaded.", self.data_holder)
        except (IOError, json.JSONDecodeError):
            print(f"File {file_address} not found/decodable. No best ratio is loaded.")

    def save(self, file_address: str) -> None:
        with open(file_address, "w", encoding="utf-8") as fid:
            fid.write(json.dumps([list(p) for p in self.data_holder]))

    @staticmethod
    def create_common_iterations(h1: "BestRatioHolder", h2: "BestRatioHolder"
                                 ) -> "BestRatioHolder":
        result = BestRatioHolder(h1.max_size)
        for (curr_iter, _) in h1.data_holder:
            found_itr, found_div = h2.get_point_with_itr(curr_iter)
            if found_itr is not None:
                result.add_point(found_itr, found_div)
        return result

    def __str__(self) -> str:
        return str(self.data_holder)


def load_samples_for_testing(data_set, sample_count: int, neighborhood: int,
                             shadow_map: np.ndarray, fetch_shadows: bool) -> np.ndarray:
    """Random shadow (or lit) pixel samples, CASI bands only."""
    band_size = data_set.get_casi_band_count()
    sm = np.asarray(shadow_map)
    if neighborhood > 0:
        sm = sm[neighborhood:-neighborhood, neighborhood:-neighborhood]
    indices = np.where(sm > 0) if fetch_shadows else np.where(sm == 0)
    samples = []
    for _ in range(sample_count):
        ridx = random.randint(0, indices[0].size - 1)
        x, y = indices[1][ridx], indices[0][ridx]
        samples.append(data_set.get_data_point(x, y)[:, :, :band_size])
    return np.asarray(samples, dtype=np.float32)


def compute_ratio_stats(generated: np.ndarray, originals: np.ndarray,
                        shadow_ratio: np.ndarray):
    """``(ratio, mean, std, div_mean, div_upper)`` over the samples."""
    # zero-valued original bands produce inf/nan ratios; those rows are
    # dropped by the finite mask below exactly as the JAX package's do,
    # so suppress only the warning, not the values
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.squeeze(generated / originals, axis=(1, 2)) * shadow_ratio
    finite = np.all(np.isfinite(ratio), axis=1)
    ratio = ratio[finite]
    mean = ratio.mean(axis=0)
    std = ratio.std(axis=0)
    div_mean = divergence_for_ratios(mean)
    div_upper = abs(js_divergence(np.abs(mean + std - 1), np.zeros_like(mean)))
    return ratio, mean, std, div_mean, div_upper


def plot_overall_info(bands, mean, lower_bound, upper_bound, iteration,
                      plt_name, log_dir) -> None:
    """Percentile band-ratio pdf plot; without matplotlib, a line that says
    it was not written."""
    path = os.path.join(log_dir, f"{plt_name}_{iteration}.pdf")
    plt = pyplot(path)
    if plt is None:
        return
    plt.rcParams["font.size"] = 14
    plt.scatter(bands, mean, label="mean ratio", s=10)
    plt.plot(bands, mean)
    plt.fill_between(bands, lower_bound, upper_bound, alpha=0.2)
    plt.xlabel("Spectral band(nm)")
    plt.ylabel("Ratio between generated and original samples")
    plt.ylim([-1, 4])
    plt.yticks(list(range(-1, 5)))
    plt.grid()
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.clf()


def print_overall_info(mean: np.ndarray, std: np.ndarray) -> None:
    print("Mean&std Generated vs Original Ratio: ")
    for i in range(mean.shape[0]):
        prefix = "[ " if i == 0 else ""
        postfix = " ]" if i == mean.shape[0] - 1 else ""
        print(f"{prefix}{mean[i]:2.4f}±{std[i]:2.2f}{postfix}",
              end="\n" if i % 5 == 1 else " ")
    print()


class DirectionValidator:
    """One direction's validation state."""

    def __init__(self, name_suffix: str, log_dir: str, bands: np.ndarray,
                 samples: np.ndarray, shadow_ratio: np.ndarray):
        self.name_suffix = name_suffix
        self.log_dir = log_dir
        self.bands = bands
        self.samples = samples
        self.shadow_ratio = shadow_ratio
        self.best_mean_div_holder = BestRatioHolder(10)
        self.best_upper_div_holder = BestRatioHolder(10)
        self._best_addr = os.path.join(log_dir, f"best_ratio_{name_suffix}.json")
        self.best_mean_div_holder.load(self._best_addr)

    def run(self, translate_fn, iteration: int, plot: bool = True) -> float:
        generated = np.asarray(translate_fn(self.samples))
        ratio, mean, std, div_mean, div_upper = compute_ratio_stats(
            generated, self.samples, self.shadow_ratio)
        self.best_mean_div_holder.add_point(iteration, div_mean)
        self.best_mean_div_holder.save(self._best_addr)
        self.best_upper_div_holder.add_point(iteration, div_upper)
        print(f"Validation metrics for {self.name_suffix} #{iteration}")
        print_overall_info(mean, std)
        if plot:
            plot_overall_info(self.bands,
                              np.percentile(ratio, 50, axis=0),
                              np.percentile(ratio, 10, axis=0),
                              np.percentile(ratio, 90, axis=0),
                              iteration, f"band_ratio_{self.name_suffix}", self.log_dir)
        print(f"Divergence for {self.name_suffix}; mean:{div_mean}, upper:{div_upper}")
        print(f"Best {self.name_suffix} options:{self.best_mean_div_holder}")
        return div_mean


class PeerValidator:
    """Shadow + de-shadow validation pair."""

    def __init__(self, loader, data_set, shadow_map, shadow_ratio, neighborhood,
                 sample_count, log_dir):
        bands = loader.get_band_measurements()
        lit_samples = load_samples_for_testing(data_set, sample_count, neighborhood,
                                               shadow_map, fetch_shadows=False)
        shadow_samples = load_samples_for_testing(data_set, sample_count, neighborhood,
                                                  shadow_map, fetch_shadows=True)
        self.shadowed = DirectionValidator(
            "shadowed", log_dir, bands, lit_samples,
            adj_shadow_ratio(shadow_ratio, is_shadow=False))
        self.deshadowed = DirectionValidator(
            "deshadowed", log_dir, bands, shadow_samples,
            adj_shadow_ratio(shadow_ratio, is_shadow=True))

    def run(self, shadow_fn, deshadow_fn, iteration: int, plot: bool = True):
        self.shadowed.run(shadow_fn, iteration, plot=plot)
        self.deshadowed.run(deshadow_fn, iteration, plot=plot)
        print("Best common options:",
              BestRatioHolder.create_common_iterations(
                  self.shadowed.best_mean_div_holder,
                  self.deshadowed.best_mean_div_holder))

    def get_best_mean_div(self):
        return [h for h in (self.shadowed.best_mean_div_holder.get_best_diver(),
                            self.deshadowed.best_mean_div_holder.get_best_diver())
                if h is not None]

    def get_best_upper_div(self):
        return [h for h in (self.shadowed.best_upper_div_holder.get_best_diver(),
                            self.deshadowed.best_upper_div_holder.get_best_diver())
                if h is not None]
