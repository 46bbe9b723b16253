"""The classic-ML baselines of the port (``hypelcnn_tpu_torch/classic/``,
``apps/classic_ml_trainer.py``) against scikit-learn, which the JAX package's
trainer calls: the metrics and the splitter exactly, one tree's predictions
exactly on data whose ties cannot change them, the forest's accuracy and the
SVM's predictions and grid scores closely; and the CLI against the JAX CLI:
its windows bit for bit, its files by name and format."""

import os

import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.classic import metrics
from hypelcnn_tpu_torch.classic.forest import RandomForestClassifier, grow_trees
from hypelcnn_tpu_torch.classic.model_selection import StratifiedShuffleSplit, grid_search
from hypelcnn_tpu_torch.classic.svm import fit_many
from hypelcnn_tpu_torch.data import layouts
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

sklearn = pytest.importorskip("sklearn")
from sklearn import metrics as sk_metrics  # noqa: E402
from sklearn.ensemble import RandomForestClassifier as SkForest  # noqa: E402
from sklearn.model_selection import GridSearchCV  # noqa: E402
from sklearn.model_selection import StratifiedShuffleSplit as SkSplit  # noqa: E402
from sklearn.svm import SVC as SkSVC  # noqa: E402
from sklearn.tree import DecisionTreeClassifier  # noqa: E402

SCENE = "synthetic://?h=32&w=40&bands=8&classes=3"


@pytest.mark.parametrize("seed", range(6))
def test_metrics_equal_scikit_learn(seed):
    """Random labels; some classes never predicted, some only predicted."""
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, 7, 300)
    y_pred = np.where(rng.random(300) < 0.6, y_true, rng.integers(2, 9, 300))
    y_pred[y_pred == 3] = 4  # class 3 is never predicted; 7 and 8 only predicted
    np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred),
                                  sk_metrics.confusion_matrix(y_true, y_pred))
    for ours, theirs in ((metrics.accuracy_score, sk_metrics.accuracy_score),
                         (metrics.balanced_accuracy_score, sk_metrics.balanced_accuracy_score),
                         (metrics.cohen_kappa_score, sk_metrics.cohen_kappa_score)):
        assert ours(y_true, y_pred) == pytest.approx(theirs(y_true, y_pred), rel=0, abs=1e-12)


@pytest.mark.parametrize("n_splits, test_size, seed", [(2, 0.1, 42), (3, 0.25, 7), (1, 0.3, 0)])
def test_split_indices_equal_scikit_learn(n_splits, test_size, seed):
    y = np.random.default_rng(seed).integers(0, 5, 257)
    ours = list(StratifiedShuffleSplit(n_splits=n_splits, test_size=test_size,
                                       random_state=seed).split(None, y))
    theirs = list(SkSplit(n_splits=n_splits, test_size=test_size,
                          random_state=seed).split(np.zeros((257, 1)), y))
    assert len(ours) == len(theirs) == n_splits
    for (a_train, a_test), (b_train, b_test) in zip(ours, theirs):
        np.testing.assert_array_equal(a_train, b_train)
        np.testing.assert_array_equal(a_test, b_test)


def _one_tree(x, y):
    """One tree on every sample once (no bootstrap), visiting every feature."""
    forest = RandomForestClassifier(n_estimators=1, max_features=x.shape[1])
    forest.classes_ = np.unique(y)
    labels = torch.from_numpy(np.searchsorted(forest.classes_, y))
    forest.trees = grow_trees(torch.from_numpy(x), labels,
                              torch.ones((1, x.shape[0]), dtype=torch.int64),
                              forest.classes_.shape[0], x.shape[1],
                              [torch.Generator().manual_seed(0)])
    return forest


def _tie_free(kind: str, seed: int):
    """Data on which every split a tree could choose leads to the same
    predictions. ``latent``: each feature an increasing affine map of one
    latent variable, with label noise (a tie between two features' splits is
    a cut at the same latent value). ``blocks``: the class set by two of six
    features at two thresholds, no noise, no test point near a boundary (each
    node's best split is unique)."""
    rng = np.random.default_rng(seed)
    if kind == "latent":
        latent = rng.uniform(0, 10, 800)
        x = (latent[:, None] * rng.uniform(0.5, 3, 6) + rng.uniform(-5, 5, 6)).astype(np.float32)
        y = (np.floor(latent * 1.7) % 4).astype(int)
        flip = rng.random(800) < 0.1
        y[flip] = rng.integers(0, 4, int(flip.sum()))
        return x[:300], y[:300], x[300:]
    x = rng.uniform(0, 1, (900, 6)).astype(np.float32)
    y = (x[:, 0] > 0.3).astype(int) + 2 * (x[:, 1] > 0.6)
    test = x[300:][(np.abs(x[300:, 0] - 0.3) > 0.02) & (np.abs(x[300:, 1] - 0.6) > 0.02)]
    return x[:300], y[:300], test


@pytest.mark.parametrize("kind", ["latent", "blocks"])
@pytest.mark.parametrize("seed", range(3))
def test_one_tree_predicts_as_a_decision_tree_on_tie_free_data(kind, seed):
    x, y, test = _tie_free(kind, seed)
    want = DecisionTreeClassifier(random_state=seed).fit(x, y).predict(test)
    np.testing.assert_array_equal(_one_tree(x, y).predict(torch.from_numpy(test)), want)


def _blobs():
    """Six overlapping Gaussian classes in 30 features: forests reach ~0.73."""
    rng = np.random.default_rng(5)
    means = rng.normal(size=(6, 30)) * 0.5

    def draw(n):
        y = rng.integers(0, 6, n)
        return (means[y] + rng.normal(size=(n, 30))).astype(np.float32), y

    return (*draw(1000), *draw(3000))


def test_forest_accuracy_is_scikit_learns_and_repeats_under_np_random_seed():
    """Over 3 seeds, the overall accuracy within 0.02 of
    ``RandomForestClassifier(n_estimators=50, max_features=24)``'s on data
    the forests do not separate; the same ``np.random`` state grows the same
    forest."""
    x, y, vx, vy = _blobs()
    ours, theirs = [], []
    for seed in range(3):
        np.random.seed(seed)
        forest = RandomForestClassifier(n_estimators=50, max_features=24).fit(
            torch.from_numpy(x), y)
        ours.append((forest.predict(torch.from_numpy(vx)) == vy).mean())
        sk = SkForest(n_estimators=50, max_features=24, random_state=seed).fit(x, y)
        theirs.append((sk.predict(vx) == vy).mean())
    assert 0.5 < np.mean(theirs) < 0.9
    assert abs(np.mean(ours) - np.mean(theirs)) < 0.02
    np.random.seed(2)
    again = RandomForestClassifier(n_estimators=50, max_features=24).fit(torch.from_numpy(x), y)
    for a, b in zip(forest.trees, again.trees):
        for name in ("feature", "threshold", "left", "right", "value"):
            assert torch.equal(getattr(a, name), getattr(b, name))


def test_trees_grown_together_are_the_trees_grown_alone():
    """The card grows a batch of trees level by level at once, the CPU one at
    a time: each tree is the same either way (features constant in a node
    included, which send it past its first visited features)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 30)).astype(np.float32)
    x[:, 10:20] = np.round(x[:, 10:20] * 0.3)
    y = torch.from_numpy(rng.integers(0, 4, 600) + (x[:, 0] > 0))
    x = torch.from_numpy(x)

    def draws(seed):
        generator = torch.Generator().manual_seed(seed)
        return generator, torch.bincount(torch.randint(0, 600, (600,), generator=generator),
                                         minlength=600)

    together = grow_trees(x, y, torch.stack([draws(s)[1] for s in (5, 6, 7)]), 5, 6,
                          [draws(s)[0] for s in (5, 6, 7)])
    for seed, tree in zip((5, 6, 7), together):
        generator, weight = draws(seed)
        (alone,) = grow_trees(x, y, weight[None], 5, 6, [generator])
        assert tree.depth == alone.depth
        for name in ("feature", "threshold", "left", "right", "value"):
            assert torch.equal(getattr(tree, name), getattr(alone, name))


def _svm_data(h=40, w=80, seed=0):
    from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
    loader = SyntheticDataLoader(f"synthetic://?h={h}&w={w}&bands=144&classes=3")
    scene = loader.load_data(0, False)
    np.random.seed(seed)
    samples = loader.load_samples(0.1, 0)
    x_of = lambda t: scene.fused_host()[t[:, 1], t[:, 0]]  # noqa: E731
    return (x_of(samples.training_targets), samples.training_targets[:, 2],
            x_of(samples.validation_targets)[:1500], samples.validation_targets[:1500, 2])


@pytest.mark.parametrize("c, gamma", [(1.0, 1e-9), (1e4, 1e-7), (0.01, 1e-5)])
def test_svc_predicts_as_scikit_learn(c, gamma):
    x, y, vx, _ = _svm_data()
    want = SkSVC(C=c, gamma=gamma).fit(x, y).predict(vx)
    got = fit_many(torch.from_numpy(x), y, [c], [gamma]).predict(torch.from_numpy(vx))[0]
    assert (got == want).mean() >= 0.99


def test_grid_scores_are_grid_search_cvs():
    x, y, _, _ = _svm_data(h=24, w=48, seed=1)
    c_range, gamma_range = np.logspace(-2, 10, 13), np.logspace(-9, 3, 13)
    cv = dict(n_splits=2, test_size=0.1, random_state=42)
    ours = grid_search(torch.from_numpy(x), y, c_range, gamma_range,
                       StratifiedShuffleSplit(**cv))
    theirs = GridSearchCV(SkSVC(), param_grid=dict(gamma=gamma_range, C=c_range),
                          cv=SkSplit(**cv)).fit(x, y)
    assert [p for p in ours["params"]] == list(theirs.cv_results_["params"])
    np.testing.assert_allclose(ours["mean_test_score"], theirs.cv_results_["mean_test_score"],
                               rtol=0, atol=0.02)
    assert repr(ours["best_params"]) == repr(theirs.best_params_)


@pytest.fixture(scope="module")
def grss2018_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("grss2018")
    layouts.write_grss2018(str(root), casi_height=1202, casi_width=600, bands=4, gt_width=6,
                           labelled_fraction=0.5, outlier_fraction=0.01)
    return str(root)


@pytest.fixture(scope="module")
def gulfport_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gulfport")
    layouts.write_gulfport(str(root), height=40, width=30, bands=6)
    return str(root)


def _mixed(monkeypatch):
    from hypelcnn_tpu.data.loaders.base import LoadingMode as JaxMode
    from hypelcnn_tpu.data.loaders.gulfport_alt import GULFPORTALTDataLoader as JaxAlt
    from hypelcnn_tpu_torch.data.loaders.base import LoadingMode
    from hypelcnn_tpu_torch.data.loaders.gulfport_alt import GULFPORTALTDataLoader
    for cls, enum in ((GULFPORTALTDataLoader, LoadingMode), (JaxAlt, JaxMode)):
        original = cls.__init__

        def init(self, base_dir, _init=original, _mode=enum.MIXED):
            _init(self, base_dir)
            self.load_mode = _mode
        monkeypatch.setattr(cls, "__init__", init)


@pytest.mark.parametrize("loader_name, neighborhood", [
    ("SyntheticDataLoader", 0), ("SyntheticDataLoader", 2), ("GRSS2018DataLoader", 1),
    ("GULFPORTALTDataLoader", 1)])
def test_cli_windows_equal_the_jax_host_windows(loader_name, neighborhood, grss2018_root,
                                                gulfport_root, monkeypatch):
    """Unnormalized scenes, as the CLI loads them: a ``Scene`` (the gather),
    a ``DualResScene`` (LiDAR cast through CASI's uint16, as the host
    window does) and a ``MultiScene`` (members drawn from ``np.random``)."""
    from hypelcnn_tpu.core.registry import get_loader_from_name as jax_loader
    from hypelcnn_tpu.data.importers import _gather_all_host
    from hypelcnn_tpu_torch.apps.classic_ml_trainer import gather_windows
    from hypelcnn_tpu_torch.core.registry import get_loader_from_name
    path = {"SyntheticDataLoader": SCENE, "GRSS2018DataLoader": grss2018_root,
            "GULFPORTALTDataLoader": gulfport_root}[loader_name]
    if loader_name == "GULFPORTALTDataLoader":
        _mixed(monkeypatch)
    windows = []
    for get in (get_loader_from_name, jax_loader):
        np.random.seed(4)
        loader = get(loader_name, path)
        scene = loader.load_data(neighborhood, False)
        targets = loader.load_samples(0.1, 0).training_targets
        windows.append((scene, targets))
    (scene, targets), (jax_scene, jax_targets) = windows
    np.testing.assert_array_equal(targets, jax_targets)
    np.random.seed(9)
    got = gather_windows(scene, targets, torch.device("cpu")).numpy()
    np.random.seed(9)
    want = _gather_all_host(jax_scene, jax_targets).reshape(targets.shape[0], -1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_cli_writes_the_jax_clis_files(tmp_path, capsys):
    from hypelcnn_tpu.apps.classic_ml_trainer import main as jax_main
    from hypelcnn_tpu_torch.apps.classic_ml_trainer import main
    from hypelcnn_tpu_torch.utils.tiff_io import imread
    args = ["--loader_name=SyntheticDataLoader", f"--path={SCENE}", "--neighborhood=0",
            "--fullscene", "--batch_size=100"]
    np.random.seed(0)
    jax_main([*args, f"--base_log_path={tmp_path / 'jax'}", f"--output_path={tmp_path / 'jax'}"])
    jax_out = capsys.readouterr().out
    np.random.seed(0)
    runs = main([*args, "--device=cpu", f"--base_log_path={tmp_path / 'port'}",
                 f"--output_path={tmp_path / 'port'}"])
    out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "confusion_matrix_SyntheticDataLoader_run0.csv", "metrics_SyntheticDataLoader_run0.txt",
        "params_SyntheticDataLoader_run0.json", "result_colorized.tif", "result_raw.tif"]
    for name in names[:2]:  # a separable scene: both classify every validation window
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    params = (tmp_path / "port" / names[2]).read_text()
    assert params == repr(SkForest().set_params(**eval(params)).get_params()) + "\n"
    assert eval(params)["n_estimators"] == 50 and eval(params)["max_features"] == 24
    for name in names[3:]:
        ours, theirs = imread(str(tmp_path / "port" / name)), imread(str(tmp_path / "jax" / name))
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert (ours == theirs).mean() > 0.99
    strip = [line for line in out.splitlines() if not line.startswith("Completed training")]
    assert strip == [line for line in jax_out.splitlines()
                     if not line.startswith("Completed training")]
    assert runs[0]["overall_accuracy"] == 1.0
    # the batch size moves memory, not the map
    np.random.seed(0)
    main([*args[:-1], "--batch_size=37", "--device=cpu", f"--base_log_path={tmp_path / 'b'}",
          f"--output_path={tmp_path / 'b'}"])
    np.testing.assert_array_equal(imread(str(tmp_path / "b" / "result_raw.tif")),
                                  imread(str(tmp_path / "port" / "result_raw.tif")))


def test_hyperparamopt_prints_the_best_cell_as_the_jax_cli(capsys, monkeypatch):
    from hypelcnn_tpu.apps import classic_ml_trainer as jax_app
    from hypelcnn_tpu_torch.apps.classic_ml_trainer import perform_hyperparamopt
    # one process: the JAX CLI's 16 workers take longer to start than to fit
    monkeypatch.setattr(jax_app, "GridSearchCV",
                        lambda *args, **kwargs: GridSearchCV(*args, **{**kwargs, "n_jobs": None}))
    x, y, _, _ = _svm_data(h=24, w=32, seed=2)
    jax_app.perform_hyperparamopt(x, y)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    perform_hyperparamopt(torch.from_numpy(x), y)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["Fitting 2 folds for each of 169 candidates, totalling 338 fits", want]
