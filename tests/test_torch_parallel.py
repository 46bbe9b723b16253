"""The PyTorch port's distributed runtime and mesh in one process (no group).

The multi-process behaviour is in ``test_torch_multiprocess.py`` and
``test_torch_multiprocess_gan.py``.
"""

import pytest
import torch
import torch.distributed as dist

from hypelcnn_tpu_torch.apps import gan_train_for_shadow, train_for_classification
from hypelcnn_tpu_torch.parallel import distributed
from hypelcnn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    bind_mesh,
    bound_mesh,
    create_mesh,
    pad_to_multiple,
    shard_params_for_tp,
)
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.models.layers import Dropout, SlimBatchNorm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)


def test_single_process_is_untouched(no_torchrun):
    assert distributed.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_chief() is True
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert distributed.local_batch_slice(16) == 16
    assert distributed.local_batch_slice(7) == 7
    assert distributed.join_rank("cpu") == torch.device("cpu")


def test_a_partial_environment_is_an_error(no_torchrun, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(ValueError, match="world size and a rank"):
        distributed.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_local_batch_slice_needs_a_divisible_batch(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    assert distributed.local_batch_slice(16) == 8
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(7)


def test_backend_follows_the_device(monkeypatch):
    assert distributed.choose_backend("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.choose_backend("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.choose_backend("cuda", 1) == "nccl"
    assert distributed.choose_backend("cuda", 2) == "gloo"  # ranks share the card
    with pytest.raises(ValueError, match="unsupported device"):
        distributed.choose_backend("mps", 1)


def test_rank_device(monkeypatch):
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.rank_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setattr(distributed, "_LOCAL_RANK", 5)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)


def test_tensor_parallelism_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_mesh(model_parallel=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        shard_params_for_tp({}, create_mesh())
    with pytest.raises(ValueError):
        create_mesh(model_parallel=0)


def test_one_rank_mesh_runs_no_collective():
    mesh = create_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert not mesh.sharded
    t = torch.arange(4.0)
    assert mesh.all_reduce_(t) is t
    a, b = mesh.mean([torch.ones(2, 2), torch.tensor(3.0)])
    assert torch.equal(a, torch.ones(2, 2)) and float(b) == 3.0
    mesh.barrier()


def test_a_mesh_reduces_over_a_process_group_of_its_own_size(tmp_path):
    """One rank runs no collective even inside a process group; a mesh
    whose size is not the group's is an error, not a wrong sum."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        t = torch.arange(4.0)
        assert create_mesh().mean([t])[0] is t
        with pytest.raises(RuntimeError, match="process group of 2 ranks"):
            Mesh(2, 0).all_reduce_(t)
        with pytest.raises(RuntimeError, match="process group of 2 ranks"):
            Mesh(2, 0).barrier()
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        Mesh(2, 0).mean([torch.ones(2)])


def test_rows_and_split():
    assert [Mesh(2, r).rows(16) for r in range(2)] == [slice(0, 8), slice(8, 16)]
    with pytest.raises(ValueError, match="not divisible"):
        Mesh(2, 0).rows(15)
    # tensor_split's shares, the first ones one longer
    expected = [len(part) for part in torch.tensor_split(torch.arange(11), 3)]
    shares = [Mesh(3, r).split(11) for r in range(3)]
    assert [s.stop - s.start for s in shares] == expected
    assert [s.start for s in shares] == [0, 4, 8] and shares[-1].stop == 11
    assert pad_to_multiple(7, 2) == 8 and pad_to_multiple(8192, 2) == 8192


def test_bind_mesh_reaches_every_batch_coupled_layer():
    module = HYPELCNNModel().create_module(5, {"filter_count": 32}, (3, 3, 13))
    mesh = Mesh(2, 1)
    coupled = [m for m in module.modules() if isinstance(m, (SlimBatchNorm, Dropout))]
    assert coupled
    with bound_mesh(module, mesh):
        assert all(m.mesh is mesh for m in coupled)
    assert all(m.mesh is None for m in coupled)
    bind_mesh(module, mesh)
    assert all(m.mesh is mesh for m in coupled)


@pytest.mark.parametrize("main, args", [
    (train_for_classification.main, ["--loader_name=SyntheticDataLoader"]),
    (gan_train_for_shadow.main, ["--loader_name=SyntheticDataLoader"]),
])
def test_search_mode_under_several_ranks_raises(monkeypatch, tmp_path, main, args):
    module = __import__(main.__module__, fromlist=["world_size"])
    monkeypatch.setattr(module, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="ROADMAP"):
        main([*args, "--device=cpu", f"--flag_config_file_opt={tmp_path / 'space.json'}",
              f"--base_log_path={tmp_path / 'run'}"])
    assert not any(tmp_path.iterdir())
