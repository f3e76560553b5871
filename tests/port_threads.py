"""Torch's intra-op threads for the port's CPU tests.

The tier-1 command runs six pytest workers side by side; each worker's torch
takes one thread a core by default, so six workers oversubscribe the cores
many times over and spend most of their time waiting on each other. A port
test module imports ``torch_threads`` (an autouse fixture), which runs its
tests on ``TORCH_THREADS`` threads and restores the count afterwards, so
modules without it (the JAX suite, ``test_torch_train_engine.py``, whose
fp32 trajectory is held at a tolerance that sees the summation order of
the default thread count) are left as they were.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)
