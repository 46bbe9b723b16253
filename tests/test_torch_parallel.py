"""The PyTorch port's distributed runtime and mesh in one process (no group).

The multi-process behaviour is in ``test_torch_multiprocess.py``,
``test_torch_multiprocess_gan.py``, ``test_torch_tensor_parallel.py`` and
``test_torch_search_ranks.py``.
"""

import pytest
import torch
import torch.distributed as dist

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
    tp_sharded_keys,
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


@pytest.mark.parametrize("model_parallel, match", [
    (0, "at least 1"),
    (2, "does not divide device count 1"),  # JAX's create_mesh's check
])
def test_a_model_axis_must_divide_the_ranks(model_parallel, match):
    with pytest.raises(ValueError, match=match):
        create_mesh(model_parallel=model_parallel)


def test_a_two_axis_mesh_deals_rows_by_data_index():
    """Rank r of data x model has data index r // model and model index
    r % model, as JAX reshapes the devices (n // mp, mp)."""
    meshes = [Mesh(6, r, model_parallel=3) for r in range(6)]
    assert meshes[4].shape == {DATA_AXIS: 2, MODEL_AXIS: 3}
    assert [(m.data_rank, m.model_rank) for m in meshes] == \
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert [m.rows(8) for m in meshes] == [slice(0, 4)] * 3 + [slice(4, 8)] * 3
    assert [m.split(5) for m in meshes] == [slice(0, 3)] * 3 + [slice(3, 5)] * 3
    assert meshes[0].sharded and meshes[0].tensor_parallel
    assert not Mesh(2, 1, model_parallel=2).sharded
    full = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(meshes[2].shard(full), full[4:6])
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(4, 0, model_parallel=3)
    with pytest.raises(RuntimeError, match="subgroups"):
        meshes[0].all_reduce_(torch.ones(2))


def test_shard_params_for_tp_keeps_a_model_rank_slice():
    """JAX's rule on the port's names: a Conv_0 or Dense_0 kernel whose output
    channels number at least min_width and divide over the axis."""
    state = {"a.Conv_0.weight": torch.arange(64.0 * 3).reshape(64, 3, 1, 1),
             "a.Conv_0.bias": torch.zeros(64),
             "b.Dense_0.weight": torch.zeros(66, 4),
             "c.Dense_0.weight": torch.zeros(32, 4),
             "d_fused.conv1x1_kernel": torch.zeros(64, 3, 1, 1),
             "digitcaps_w": torch.zeros(64, 64, 64)}
    mesh = Mesh(4, 3, model_parallel=4)
    sharded = shard_params_for_tp(state, mesh)
    assert torch.equal(sharded["a.Conv_0.weight"], state["a.Conv_0.weight"][48:])
    assert all(sharded[k] is state[k] for k in state if k != "a.Conv_0.weight")
    assert tp_sharded_keys(state, 2) == ["a.Conv_0.weight", "b.Dense_0.weight"]
    assert tp_sharded_keys(state, 1) == []
    assert shard_params_for_tp(state, create_mesh()) == state


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
