"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs the CUDA devices the cell asks for in
``BENCHMARK.json``; without them it exits non-zero and prints no result.
The last line of standard output is the result as one JSON object; the
numbers that decide ``correct`` are also the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches in the checkout, at fixed paths: only a checkout's first run builds
_CACHE = ROOT / ".portbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
