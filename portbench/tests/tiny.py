"""A cell's sizes cut down so that a run fits a CPU test: the harness's
``overrides`` (the published widths stay in the configuration files)."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SCENE = {"height": 20, "width": 24, "casi_bands": 8, "classes": 5}
SWEEP = {"calibration_windows": 64, "check_pixels": 100000, "check_block": 256}
TRAIN = {"batch": 64, "train_targets": 200, "table_steps": 200, "warmup_steps": 2,
         "traced_steps": 3}
CELLS = ["hypelcnn480.sweep", "hypelcnn480.train_b16384", "dualcnn.sweep", "dualcnn.train_b4096"]


def overrides(workload: str) -> dict:
    return {"params": {"filter_count": 32}, "scene": SCENE,
            **(SWEEP if workload.endswith("sweep") else TRAIN)}


def run(workload: str, seed: int = 2 ** 31 + 11, trace: bool = False, root: Path = ROOT,
        **kwargs) -> dict:
    from portbench.harness import run_cell

    return run_cell(root, workload, seed, 0.2, trace, "cpu", overrides=overrides(workload),
                    **kwargs)
