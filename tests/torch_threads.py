"""The port's CPU test files' module fixture: one torch thread a worker.

The tier-1 command runs six pytest workers on the host's cores; torch's
default intra-op pool in each would take every core and the workers would
oversubscribe them.  A test file imports ``one_torch_thread`` (autouse,
module scope) to keep its plain versions' small tensors on one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions' small tensors run on one thread: under the
    suite's parallel workers the rest of the cores go to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
