"""One intra-op thread for torch while a port test module runs.

The tier-1 run puts several pytest workers on one machine; torch's default
of one OpenMP thread per core in every worker oversubscribes the cores, and
the small tensors of these tests gain nothing from more threads. Importing
``one_torch_thread`` into a test module applies it to that module, and the
count before it is restored after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
