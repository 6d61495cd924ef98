"""An autouse fixture for the port's test modules: torch ops on one thread
while the module runs. The suite's workers share the machine's cores, and
torch's intra-op pool of a thread a core in every worker oversubscribes
them: a CPU serve check of capacity_run.py or a check_all case then runs
10-50 times slower than alone. Results do not depend on the thread count.
Imports no JAX, so the card-only modules use it too:

    from one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
