"""Hyperparameter search (``hypelcnn_tpu/tune/search.py``) on the stdlib and sqlite3.

A search-space JSON grammar: a dict with ``min``/``max`` (optionally
``step``, ``log``) suggests a float or an int by the type of its bounds, a
list suggests a categorical, and any other value pins the key. The
``objective`` runner repeats each trial ``opt_run_count`` times, each run
under a random log-dir suffix, and scores the max of the per-run means.

When the ``optuna`` package imports it is used (same study and storage
semantics); that branch is untested, since no machine this port runs on has
optuna. Otherwise the built-in engine runs: random exploration for the first
``N_STARTUP`` trials, then a TPE-style good/bad split, where candidates are
drawn around the best-quantile trials' values (a truncated Gaussian per
dimension, a categorical by frequency), with sqlite persistence that a rerun
loads. A study with a ``seed`` draws trial ``n`` from
``random.Random(seed + n)``, so two seeded studies suggest the same values.

Under several ranks (torchrun) one search runs over all of them: the chief
alone holds the study with its storage, draws each trial's parameters and
each run's log-dir suffix, and records the value; :func:`objective` hands
the draws to every rank (``parallel/distributed.py`` ``from_chief``), every
rank runs the same episodes on the mesh, and every rank returns the
chief's value. The other ranks optimize an in-memory :class:`Study` whose
trials take the chief's suggestions.
"""

from __future__ import annotations

import json
import math
import os
import random
import sqlite3
import string
from statistics import mean
from typing import Any, Callable, Dict, List, Optional

from hypelcnn_tpu_torch.parallel.distributed import from_chief, is_chief

try:  # pragma: no cover - exercised only where optuna exists
    import optuna as _optuna
    HAVE_OPTUNA = True
except ImportError:
    _optuna = None
    HAVE_OPTUNA = False

# Constants follow optuna TPE's shape (gamma quantile split, n_startup_trials,
# n_ei_candidates=24); values match optuna defaults where one exists and are
# otherwise chosen, not tuned.
GAMMA = 0.25          # top quantile treated as "good"
N_STARTUP = 8         # random trials before guided sampling
CANDIDATES = 24       # candidate draws per guided suggestion (optuna default)


class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self._rng = random.Random(study.seed + number if study.seed is not None else None)

    # ---- suggestion API (optuna-compatible subset) ----

    def _guided_numeric(self, name, low, high, log):
        """Parzen-estimator (TPE) suggestion: candidates are drawn around
        each good trial's value (a Gaussian mixture, so multimodal spaces are
        explored) and scored by the l(x)/g(x) density ratio against the bad
        trials."""
        good, bad = self.study._split_trials()
        xform = math.log if log else (lambda v: v)
        inv = math.exp if log else (lambda v: v)
        xs_good = [xform(t["params"][name]) for t in good if name in t["params"]]
        if len(xs_good) < 2:
            return None
        xs_bad = [xform(t["params"][name]) for t in bad if name in t["params"]]
        lo, hi = xform(low), xform(high)
        span = max(hi - lo, 1e-12)
        sigma_g = max(span / max(len(xs_good), 2), 1e-9 * span)
        sigma_b = max(span / max(len(xs_bad), 2), 1e-9 * span)
        uniform = 1.0 / span

        def mixture_pdf(x, centers, sigma):
            if not centers:
                return uniform
            acc = 0.0
            norm = 1.0 / (sigma * math.sqrt(2 * math.pi))
            for c in centers:
                acc += norm * math.exp(-((x - c) ** 2) / (2 * sigma ** 2))
            return acc / len(centers)

        best, best_score = None, -math.inf
        for _ in range(CANDIDATES):
            center = self._rng.choice(xs_good)
            cand = min(max(self._rng.gauss(center, sigma_g), lo), hi)
            # uniform floors keep both densities proper over the domain and
            # the ratio finite far from every kernel
            l_x = 0.75 * mixture_pdf(cand, xs_good, sigma_g) + 0.25 * uniform
            g_x = 0.75 * mixture_pdf(cand, xs_bad, sigma_b) + 0.25 * uniform
            score = math.log(l_x) - math.log(g_x)
            if score > best_score:
                best, best_score = cand, score
        return inv(best)

    def suggest_float(self, name: str, low: float, high: float,
                      step: Optional[float] = None, log: bool = False) -> float:
        if log and (low <= 0 or step is not None):
            # optuna's contract (same as suggest_int): positive domain, no step
            raise ValueError(
                f"suggest_float({name!r}): log=True requires low > 0 and "
                f"step=None (got low={low}, step={step})")
        if self.study._n_completed() >= N_STARTUP:
            guided = self._guided_numeric(name, low, high, log)
        else:
            guided = None
        if guided is None:
            if log:
                value = math.exp(self._rng.uniform(math.log(low), math.log(high)))
            else:
                value = self._rng.uniform(low, high)
        else:
            value = guided
        if step:
            value = low + round((value - low) / step) * step
            value = min(max(value, low), high)
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int, step: int = 1,
                    log: bool = False) -> int:
        """optuna's suggest_int semantics: uniform over the valid int grid
        {low, low+step, ...} (not a rounded float draw, which would halve the
        endpoint probabilities), log-uniform when ``log``."""
        if log and (low <= 0 or step != 1):
            # optuna's contract: log-int draws require a positive domain and
            # reject step != 1 (a snapped log draw would be a linear grid)
            raise ValueError(
                f"suggest_int({name!r}): log=True requires low > 0 and "
                f"step == 1 (got low={low}, step={step})")
        guided = self._guided_numeric(name, low, high, log) \
            if self.study._n_completed() >= N_STARTUP else None
        if guided is None:
            if log:
                value = math.exp(self._rng.uniform(math.log(low), math.log(high)))
            else:
                n_grid = (high - low) // step + 1
                value = low + self._rng.randrange(n_grid) * step
        else:
            value = guided
        value = int(low + round((value - low) / step) * step)
        value = min(max(value, low), high)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices: List[Any]) -> Any:
        good = self.study._good_trials()
        values = [t["params"][name] for t in good if name in t["params"]]
        # 0.7 exploit probability mirrors optuna TPE's default weighting of
        # the "good" mixture component; chosen, not tuned
        if len(values) >= 2 and self.study._n_completed() >= N_STARTUP \
                and self._rng.random() < 0.7:
            counts = {json.dumps(c, sort_keys=True, default=str): 1.0 for c in choices}
            for v in values:
                key = json.dumps(v, sort_keys=True, default=str)
                counts[key] = counts.get(key, 1.0) + 1.0
            keys = [json.dumps(c, sort_keys=True, default=str) for c in choices]
            weights = [counts[k] for k in keys]
            choice = self._rng.choices(range(len(choices)), weights=weights)[0]
        else:
            choice = self._rng.randrange(len(choices))
        value = choices[choice]
        self.params[name] = value
        return value


class Study:
    def __init__(self, study_name: str, direction: str = "minimize",
                 storage: Optional[str] = None, seed: Optional[int] = None):
        self.study_name = study_name
        self.direction = direction
        self.seed = seed
        self.trials: List[Dict[str, Any]] = []
        self._db_path = None
        if storage and storage.startswith("sqlite:///"):
            self._db_path = storage[len("sqlite:///"):]
            self._load()

    # ---- persistence ----

    def _connect(self):
        conn = sqlite3.connect(self._db_path)
        conn.execute("CREATE TABLE IF NOT EXISTS trials ("
                     "study TEXT, number INTEGER, value REAL, params TEXT)")
        return conn

    def _load(self) -> None:
        if not self._db_path or not os.path.exists(self._db_path):
            return
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT number, value, params FROM trials WHERE study=? ORDER BY number",
                (self.study_name,)).fetchall()
        self.trials = [{"number": n, "value": v, "params": json.loads(p)}
                       for (n, v, p) in rows]
        if self.trials:
            print(f"Loaded {len(self.trials)} prior trials for study {self.study_name}")

    def _persist(self, trial_record) -> None:
        if not self._db_path:
            return
        with self._connect() as conn:
            conn.execute("INSERT INTO trials VALUES (?, ?, ?, ?)",
                         (self.study_name, trial_record["number"], trial_record["value"],
                          json.dumps(trial_record["params"], default=str)))

    # ---- engine ----

    def _n_completed(self) -> int:
        return len(self.trials)

    def _split_trials(self):
        """(good, bad): top GAMMA quantile by objective vs the rest."""
        if not self.trials:
            return [], []
        reverse = self.direction == "maximize"
        ordered = sorted(self.trials, key=lambda t: t["value"], reverse=reverse)
        n_good = max(1, int(len(ordered) * GAMMA))
        return ordered[:n_good], ordered[n_good:]

    def _good_trials(self) -> List[Dict[str, Any]]:
        return self._split_trials()[0]

    def optimize(self, objective_func: Callable, n_trials: int = 10) -> None:
        for _ in range(n_trials):
            trial = Trial(self, len(self.trials))
            value = objective_func(trial)
            record = {"number": trial.number, "value": float(value), "params": trial.params}
            self.trials.append(record)
            self._persist(record)
            print(f"Trial {trial.number} finished: value={value:g} params={trial.params} "
                  f"(best={self.best_value:g})")

    @property
    def best_trial(self) -> Dict[str, Any]:
        reverse = self.direction == "maximize"
        return sorted(self.trials, key=lambda t: t["value"], reverse=reverse)[0]

    @property
    def best_value(self) -> float:
        return self.best_trial["value"]

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial["params"]


def create_study(study_name: str, direction: str = "minimize",
                 storage: Optional[str] = None, seed: Optional[int] = None):
    if HAVE_OPTUNA:  # pragma: no cover
        return _optuna.create_study(study_name=study_name, direction=direction,
                                    sampler=_optuna.samplers.TPESampler(),
                                    storage=storage, load_if_exists=True)
    return Study(study_name, direction=direction, storage=storage, seed=seed)


def apply_search_space(trial, params: Dict[str, Any],
                       params_from_json_opt: Dict[str, Any]) -> Dict[str, Any]:
    """Interpret the search-space JSON grammar into ``params``."""
    for key, value in params_from_json_opt.items():
        if isinstance(value, dict):
            if "min" in value and "max" in value:
                lo, hi = value["min"], value["max"]
                if isinstance(lo, float) and isinstance(hi, float):
                    params[key] = trial.suggest_float(
                        key, lo, hi, step=value.get("step"), log=value.get("log", False))
                elif isinstance(lo, int) and isinstance(hi, int):
                    params[key] = trial.suggest_int(key, lo, hi, step=value.get("step", 1))
                else:
                    print(f"Parameter value is put in hyper optimization config but its "
                          f"min max type is inconsistent: {key}. Using the default value")
        elif isinstance(value, list):
            params[key] = trial.suggest_categorical(key, value)
        else:
            params[key] = value
    return params


def objective(trial, params: Dict[str, Any], params_from_json_opt: Dict[str, Any],
              func_to_run: Callable, opt_run_count: int, base_log_path: str,
              device="cpu") -> float:
    """Run ``func_to_run`` ``opt_run_count`` times on the trial's params, each
    under ``base_log_path`` plus an unseeded random suffix; the max of the
    runs' mean losses. Under several ranks the chief's ``trial`` draws the
    params and the suffixes, which reach every rank by a broadcast on
    ``device``, and the chief's value is returned everywhere."""
    searched, suggested = from_chief(
        lambda: (apply_search_space(trial, {}, params_from_json_opt), dict(trial.params)),
        device)
    if not is_chief():
        trial.params = suggested
    params = {**params, **searched}
    losses = []
    for run_idx in range(opt_run_count):
        trial_postfix = from_chief(lambda: "_" + "".join(
            random.choices(string.ascii_lowercase + string.digits, k=5)), device)
        print(f"Starting run#{run_idx}")
        losses.append(mean(func_to_run(params=params,
                                       base_log_path=base_log_path + trial_postfix)))
    print("Trial runs are completed. Losses:")
    print(*losses, sep=",")
    return from_chief(lambda: max(losses), device)
