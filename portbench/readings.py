"""Readings that the limits of ``correct`` are set from (not part of a run).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --controls 3 \\
        --seconds 2 --out readings_<cell>.json

For each seed, one run of the cell as the benchmark makes it (a short
window), in one process: the numbers compared for the program (its lower
reading over the seeds), and for the first ``--controls`` seeds the same
numbers for the control (the reference in TF32, one step below the
configuration's float32 with TF32 off, put in the program's place) and for
the planted faults the cell can have. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seeds, controls: int, seconds: float, device: str = "cuda",
             overrides=None) -> dict:
    from portbench.harness import run_cell

    out = {"workload": workload, "program": {}, "faults": {}}
    for index, seed in enumerate(seeds):
        extra = {}

        def collect(driver, env, extra=extra):
            extra.update(driver.control_readings())

        result = run_cell(ROOT, workload, seed, seconds, False, device, time.perf_counter(),
                          overrides, collect if index < controls else None)
        out["program"][str(seed)] = {name: c["value"] for name, c in result["checks"].items()}
        for name, values in extra.items():
            out["faults"].setdefault(name, {})[str(seed)] = values
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "checks": out["program"][str(seed)], **extra}), flush=True)
    return out


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    result = readings(args.workload, seeds, args.controls, args.seconds)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
