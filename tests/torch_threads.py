"""A fixture for port test files whose calls issue many small torch ops.

Import it into a test module (``from torch_threads import one_torch_thread``)
to run that module's tests on one intra-op thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the importing file's calls. They issue thousands of small torch
    ops; with the other workers of a parallel test run on every core, each op's thread barrier
    waits on the scheduler, and a call that takes a second alone took minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
