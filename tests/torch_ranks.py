"""Launch the ranks of a PyTorch-port multi-process test.

:func:`run_ranks` writes the tasks to ``workdir/spec.json``, starts
``tests/torch_mp_worker.py`` once per rank with torchrun's environment (a
free local port, gloo on the CPU), waits for every rank and returns their
results, rank 0 first. The ranks are started from here, not from a test
module's own code, so that they import the port and never the JAX package.
"""

import json
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tasks, workdir, world: int = 2, timeout: int = 300) -> list:
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "spec.json")
    with open(spec, "w", encoding="utf-8") as fid:
        json.dump({"tasks": tasks, "out": str(workdir)}, fid)
    port = str(free_port())
    procs = []
    for rank in range(world):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
               "WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, WORKER, spec], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(workdir, f"rank{rank}.pt"), weights_only=True)
            for rank in range(world)]
