"""The port's hyperparameter search against the JAX package's on the CPU.

A seeded study suggests the same trials and writes the same sqlite rows as
the JAX engine, past ``N_STARTUP`` so the guided branch runs; a rerun loads
the earlier trials; each CLI's search mode hands every trial the params the
JAX CLI hands it (the episode monkeypatched, the study's seed injected); and
one real two-trial run of each port CLI. Everything is exact.
"""

import json
import math
import pathlib
import random
import sqlite3
from types import SimpleNamespace

import pytest

from hypelcnn_tpu.apps import gan_train_for_shadow as jax_gan_app
from hypelcnn_tpu.apps import train_for_classification as jax_train_app
from hypelcnn_tpu.tune import search as jax_search
from hypelcnn_tpu_torch.apps import gan_train_for_shadow, train_for_classification
from hypelcnn_tpu_torch.tune import search
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPACE = {
    "lr": {"min": 1e-4, "max": 1e-2, "log": True},
    "rate": {"min": 0.0, "max": 0.4},
    "stepped": {"min": 0.0, "max": 1.0, "step": 0.25},
    "width": {"min": 8, "max": 64, "step": 8},
    "batch": [16, 32, 64],
    "fixed": 7,
}
SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"
GAN_SPACE = CONFIGS / "gan" / "cycle_gan_flags_opt.json"


def _loss(params, base_log_path):
    """A deterministic score with a minimum inside the space."""
    del base_log_path
    return [abs(math.log10(params["lr"]) + 3) + (params["rate"] - 0.1) ** 2
            + params["stepped"] + params["width"] / 64 + params["batch"] / 64]


def _run_study(module, db, n_trials, seed=11):
    study = module.create_study("unit", direction="minimize", storage=f"sqlite:///{db}",
                                seed=seed)
    random.seed(0)
    study.optimize(lambda trial: module.objective(trial, {"base": 1}, SPACE, _loss, 2, "log"),
                   n_trials=n_trials)
    return study


def _rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute("SELECT * FROM trials ORDER BY number").fetchall()


def test_seeded_study_matches_jax_and_a_rerun_loads_the_trials(tmp_path, capsys):
    assert search.N_STARTUP < 12
    ours = _run_study(search, tmp_path / "port.db", 12)
    theirs = _run_study(jax_search, tmp_path / "jax.db", 12)
    assert ours.trials == theirs.trials
    assert _rows(tmp_path / "port.db") == _rows(tmp_path / "jax.db")
    assert [t["number"] for t in ours.trials] == list(range(12))
    # a trial's record holds its suggestions, not the pinned or passed keys
    assert all(set(t["params"]) == {"lr", "rate", "stepped", "width", "batch"}
               for t in ours.trials)
    assert ours.best_params == theirs.best_params and ours.best_value == theirs.best_value
    # guided trials draw near the good ones: not all 12 are startup draws
    assert len({t["params"]["batch"] for t in ours.trials}) > 1

    capsys.readouterr()
    again = _run_study(search, tmp_path / "port.db", 2)
    jax_again = _run_study(jax_search, tmp_path / "jax.db", 2)
    assert "Loaded 12 prior trials for study unit" in capsys.readouterr().out
    assert [t["number"] for t in again.trials] == list(range(14))
    assert again.trials == jax_again.trials
    assert _rows(tmp_path / "port.db") == _rows(tmp_path / "jax.db")


def test_search_space_grammar_and_objective_match_jax(capsys):
    """Pinned values, the int grid, the stepped float, the max over runs."""
    for module in (search, jax_search):
        study = module.Study("grammar", seed=3)
        trial = module.Trial(study, 0)
        params = module.apply_search_space(trial, {"keep": 1}, {**SPACE, "bad": {"min": 1,
                                                                                  "max": 2.0}})
        assert params["keep"] == 1 and params["fixed"] == 7 and "bad" not in params
        assert params["width"] % 8 == 0 and params["stepped"] in (0.0, 0.25, 0.5, 0.75, 1.0)
    runs = iter([[1.0, 3.0], [5.0], [0.5]])
    for module in (search, jax_search):
        value = module.objective(module.Trial(module.Study("o", seed=1), 0), {}, {"fixed": 1},
                                 lambda params, base_log_path: next(runs), 1 + (module is search),
                                 "b")
        assert value == (5.0 if module is search else 0.5)
    with pytest.raises(ValueError, match="log=True"):
        search.Trial(search.Study("x"), 0).suggest_float("a", 0.0, 1.0, log=True)


def _seeded(module, monkeypatch, seed=5):
    create = module.create_study
    monkeypatch.setattr(module, "create_study",
                        lambda *a, **kw: create(*a, **{**kw, "seed": seed}))


CLASSIFIER_SPACE = {"learning_rate": {"min": 1e-4, "max": 1e-3, "log": True},
                    "filter_count": [16, 32], "batch_size": 16, "drop_out_ratio": 0.5}


def _run_cli(app, argv, workdir, monkeypatch):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    random.seed(0)  # the run suffixes
    return app.main(argv)


def test_classifier_search_hands_each_trial_the_jax_params(tmp_path, monkeypatch):
    space = tmp_path / "space.json"
    space.write_text(json.dumps(CLASSIFIER_SPACE))
    argv = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
            f"--flag_config_file_opt={space}", "--opt_trial_count=3", "--opt_run_count=2",
            f"--base_log_path={tmp_path / 'log'}", f"--output_path={tmp_path}"]
    seen = {}
    for name, app, module in (("port", train_for_classification, train_for_classification),
                              ("jax", jax_train_app, jax_search)):
        calls = seen.setdefault(name, [])

        def episode(flags, params, model, base_log_path, device=None, calls=calls):
            calls.append((dict(params), base_log_path, type(model).__name__, device))
            return SimpleNamespace(validation_accuracy=1.0 / (1.0 + params["learning_rate"]))

        monkeypatch.setattr(app, "perform_an_episode", episode)
        _seeded(module, monkeypatch)
        _run_cli(app, argv, tmp_path / name, monkeypatch)
    assert len(seen["port"]) == len(seen["jax"]) == 6
    for ours, theirs in zip(seen["port"], seen["jax"]):
        assert ours[:3] == theirs[:3]
        assert ours[3] == train_for_classification.resolve_device("cpu")
        assert ours[0]["batch_size"] == 16 and ours[0]["device"] == "cpu"
        assert ours[1].startswith(str(tmp_path / "log") + "_")
    assert _rows(tmp_path / "port" / "classification_opt.db") == \
        _rows(tmp_path / "jax" / "classification_opt.db")


def test_gan_search_hands_each_trial_the_jax_params(tmp_path, monkeypatch):
    argv = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
            f"--flag_config_file_opt={GAN_SPACE}", "--opt_trial_count=10",
            "--opt_run_count=1", f"--base_log_path={tmp_path / 'g'}",
            f"--output_path={tmp_path}"]
    seen = {}
    for name, app, module in (("port", gan_train_for_shadow, gan_train_for_shadow),
                              ("jax", jax_gan_app, jax_search)):
        calls = seen.setdefault(name, [])

        def session(params, base_log_path, device=None, calls=calls):
            calls.append((dict(params), base_log_path, device))
            return [params["generator_lr"] * 1e3, params["identity_loss_weight"]]

        monkeypatch.setattr(app, "run_session", session)
        _seeded(module, monkeypatch)
        _run_cli(app, argv, tmp_path / name, monkeypatch)
    assert len(seen["port"]) == len(seen["jax"]) == 10
    for ours, theirs in zip(seen["port"], seen["jax"]):
        # the JAX GAN CLI has no --device flag; every other flag is the same
        assert set(ours[0]) - set(theirs[0]) == {"device"}
        assert {k: v for k, v in ours[0].items() if k != "device"} == theirs[0]
        assert ours[1] == theirs[1]
        assert ours[0]["batch_size"] in (16, 32, 64)
        assert ours[2] == gan_train_for_shadow.resolve_device("cpu")
    assert _rows(tmp_path / "port" / "gan_shadow_opt.db") == \
        _rows(tmp_path / "jax" / "gan_shadow_opt.db")


def test_classifier_search_runs_two_trials_then_a_rerun_a_third(tmp_path, monkeypatch):
    """The space pins the published JSON's every key (a key it leaves out takes
    the model's default, and the optimizer's have none) but a narrow width."""
    published = json.loads((CONFIGS / "modelconfigs" / "alg_param_hypelcnn.json").read_text())
    space = tmp_path / "space.json"
    space.write_text(json.dumps({**published, "filter_count": 32, "batch_size": 16,
                                 "learning_rate": CLASSIFIER_SPACE["learning_rate"]}))
    monkeypatch.chdir(tmp_path)
    argv = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
            "--importer_name=GeneratorImporter", "--neighborhood=1", "--step=20",
            f"--flag_config_file_opt={space}", "--opt_run_count=1",
            f"--base_log_path={tmp_path / 'log'}"]
    study = train_for_classification.main(argv + ["--opt_trial_count=2"])
    assert len(study.trials) == 2
    study = train_for_classification.main(argv + ["--opt_trial_count=1"])
    rows = _rows(tmp_path / "classification_opt.db")
    assert [row[:2] for row in rows] == [("classification_opt", n) for n in range(3)]
    assert all(0.0 <= row[2] <= 1.0 for row in rows)  # 1 - validation accuracy
    assert [t["number"] for t in study.trials] == [0, 1, 2]
    assert len(list(tmp_path.glob("log_*"))) == 3


def test_gan_search_runs_two_trials(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    study = gan_train_for_shadow.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu", "--step=2",
        "--validation_steps=2", "--validation_sample_count=10",
        f"--flag_config_file_opt={GAN_SPACE}", "--opt_trial_count=2", "--opt_run_count=1",
        f"--base_log_path={tmp_path / 'g'}"])
    rows = _rows(tmp_path / "gan_shadow_opt.db")
    assert [row[:2] for row in rows] == [("gan_shadow_opt", 0), ("gan_shadow_opt", 1)]
    assert all(math.isfinite(row[2]) for row in rows)
    assert [json.loads(row[3])["batch_size"] in (16, 32, 64) for row in rows] == [True, True]
    assert len(study.trials) == 2
