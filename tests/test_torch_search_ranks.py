"""Both train CLIs' search mode (``--flag_config_file_opt``) under two gloo ranks on the CPU.

The two ranks are started once for the module (``tests/torch_ranks.py``),
in one working directory; this process runs the same searches in one rank,
in another. Every study is seeded through the test (the CLIs keep JAX's
unseeded study), so the one-rank study suggests the same trials.

Held:

- the chief alone opens the study's sqlite storage (the other rank makes
  no connection), and the working directory holds one study file;
- both ranks hand every episode the same searched params and the same log
  dir, which the chief drew, and return the same trials;
- the trials' params equal the one-rank study's; their values (the
  classifier's ``1 - validation OA``) within 0.02, the two-rank OA
  tolerance of ``test_torch_multiprocess.py`` (measured: equal), and the
  GAN's divergences ``rel=1e-3`` (measured 3.3e-8; its losses are held to
  1e-4 in ``test_torch_multiprocess_gan.py``).
"""

import json
import sqlite3

import pytest

from hypelcnn_tpu_torch.parallel.mesh import create_mesh
from torch_mp_worker import run_search
from torch_ranks import REPO, run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CONFIGS = f"{REPO}/configs"
TRIALS, SEED = 2, 5
LEARNING_RATE = {"min": 1e-4, "max": 1e-3, "log": True}
GAN_SEARCHED = ["generator_lr", "discriminator_lr", "batch_size", "identity_loss_weight",
                "cycle_consistency_loss_weight"]


def _classifier_task(work, name):
    """The published HYPELCNN JSON pinned at a narrow width, a log-uniform
    learning rate searched (as ``test_torch_search.py`` runs it)."""
    published = json.loads(open(f"{CONFIGS}/modelconfigs/alg_param_hypelcnn.json").read())
    space = work / "classifier_space.json"
    space.write_text(json.dumps({**published, "filter_count": 32, "batch_size": 16,
                                 "learning_rate": LEARNING_RATE}))
    workdir = work / name / "classifier"
    return {"kind": "search", "name": "classifier", "app": "train", "seed": SEED,
            "searched": ["learning_rate", "filter_count", "batch_size"],
            "workdir": str(workdir),
            "argv": ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
                     "--importer_name=GeneratorImporter", "--neighborhood=1", "--step=20",
                     f"--flag_config_file_opt={space}", f"--opt_trial_count={TRIALS}",
                     "--opt_run_count=1", f"--base_log_path={workdir / 'log'}"]}


def _gan_task(work, name):
    return {"kind": "search", "name": "gan", "app": "gan", "seed": SEED,
            "searched": GAN_SEARCHED, "workdir": str(work / name / "gan"),
            "argv": ["--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu",
                     "--step=2", "--validation_steps=2", "--validation_sample_count=10",
                     f"--flag_config_file_opt={CONFIGS}/gan/cycle_gan_flags_opt.json",
                     f"--opt_trial_count={TRIALS}", "--opt_run_count=1",
                     f"--base_log_path={work / name / 'gan' / 'g'}"]}


def _tasks(work, name):
    tasks = [_classifier_task(work, name), _gan_task(work, name)]
    for task in tasks:
        (work / name / task["name"]).mkdir(parents=True)
    return tasks


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("search_ranks")


@pytest.fixture(scope="module")
def ranks(work):
    return run_ranks(_tasks(work, "two"), work / "out")


@pytest.fixture(scope="module")
def one_rank(work):
    return {task["name"]: run_search(task, create_mesh()) for task in _tasks(work, "one")}


def _rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute("SELECT study, number, params FROM trials ORDER BY number").fetchall()


@pytest.mark.parametrize("search, study", [("classifier", "classification_opt"),
                                           ("gan", "gan_shadow_opt")])
def test_one_search_over_two_ranks(ranks, one_rank, work, search, study):
    chief, other = (r[search] for r in ranks)
    assert chief["connects"] > 0 and other["connects"] == 0
    workdir = work / "two" / search
    assert sorted(p.name for p in workdir.glob("*.db")) == [f"{study}.db"]
    assert [row[:2] for row in _rows(workdir / f"{study}.db")] == \
        [(study, n) for n in range(TRIALS)]
    # every episode of both ranks had the chief's draws
    assert len(chief["episodes"]) == TRIALS
    assert chief["episodes"] == other["episodes"]
    assert len({e["log"] for e in chief["episodes"]}) == TRIALS
    assert chief["trials"] == other["trials"]

    one = one_rank[search]
    assert [t["params"] for t in chief["trials"]] == [t["params"] for t in one["trials"]]
    assert [e["params"] for e in chief["episodes"]] == [e["params"] for e in one["episodes"]]
    for mine, theirs in zip(chief["trials"], one["trials"]):
        if search == "classifier":
            assert mine["value"] == pytest.approx(theirs["value"], abs=0.02)
        else:
            assert mine["value"] == pytest.approx(theirs["value"], rel=1e-3)
