"""The multi-process runtime on ``torch.distributed`` (``hypelcnn_tpu/parallel/distributed.py``).

The JAX package runs one process per host over ``jax.distributed``; PyTorch
runs one process per card. ``torchrun`` (``python -m torch.distributed.run``)
starts the ranks and sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``; :func:`initialize_distributed` joins the group
they describe, and a run without them is left untouched.

- A rank computes on ``cuda:{LOCAL_RANK % device_count}``, or on the CPU
  when the caller asks for it (:func:`rank_device`).
- The backend follows the device: ``gloo`` on the CPU, ``nccl`` on CUDA when
  every local rank has a card of its own. NCCL refuses two ranks on one card,
  so ranks that share a card run ``gloo``, and the chief says so. A backend
  that cannot run raises; nothing moves to the CPU.
- :func:`is_chief` is rank 0, the reference's ``is_chief = task == 0``: the
  rank that writes summaries, CSVs and checkpoints; :func:`from_chief` hands
  a value the chief draws (a search trial's parameters) to every rank.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

_LOCAL_RANK: Optional[int] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def choose_backend(device_type: str, local_world_size: int) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` when each of the
    ``local_world_size`` ranks of this host has a card, else ``gloo``."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank was asked for but CUDA is not available")
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the process group of a multi-process run; True when joined.

    Arguments default to torchrun's environment (``tcp://MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); an explicit argument wins. With
    neither an address nor a world size, returns False and changes nothing.
    A group that already exists is kept. ``device`` (``cuda`` or ``cpu``)
    picks the backend, and on CUDA the rank's card becomes the current one.
    """
    global _LOCAL_RANK
    if init_method is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and world_size is None:
        return False
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None or world_size is None or rank is None:
        raise ValueError(f"a distributed run needs an address, a world size and a rank; got "
                         f"{init_method!r}, {world_size!r}, {rank!r}")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    _LOCAL_RANK = rank if local_rank is None else local_rank
    if dist.is_initialized():
        return True
    device_type = torch.device(device).type
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    backend = choose_backend(device_type, local_world)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device))
        if backend == "gloo" and rank == 0:
            print(f"{local_world} ranks share {torch.cuda.device_count()} card(s): NCCL needs "
                  "a card a rank, so the collectives run on gloo", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def join_rank(device) -> torch.device:
    """The entry points' start: join torchrun's group when its environment is
    there, and return this rank's device (``device`` itself in one plain process)."""
    device = torch.device(device)
    return rank_device(device) if initialize_distributed(device=device) else device


def finalize_distributed() -> None:
    """Leave the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_chief() -> bool:
    """Whether this process writes summaries, CSVs and checkpoints."""
    return rank() == 0


def from_chief(draw: Callable[[], Any], device="cpu") -> Any:
    """``draw()`` called on the chief alone and its value, a JSON value,
    broadcast to every rank as UTF-8 bytes in a tensor on ``device`` (the
    rank's device: NCCL broadcasts CUDA tensors only); without a group,
    ``draw()``."""
    if world_size() == 1:
        return draw()
    device = torch.device(device)
    payload = json.dumps(draw()).encode() if is_chief() else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    data = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if payload:
        data.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(data, src=0)
    return json.loads(bytes(data.cpu().numpy()).decode())


def local_batch_slice(global_batch: int) -> int:
    """This rank's share of a global batch; raises when the world size does not divide it."""
    count = world_size()
    if global_batch % count != 0:
        raise ValueError(f"global batch {global_batch} not divisible by world size {count}")
    return global_batch // count


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on: ``cuda:{LOCAL_RANK % device_count}``
    for CUDA (a device with an index is kept), the CPU when asked for."""
    device = torch.device(device)
    if device.type == "cpu" or device.index is not None:
        return device
    local = _LOCAL_RANK if _LOCAL_RANK is not None else (_env_int("LOCAL_RANK") or 0)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
