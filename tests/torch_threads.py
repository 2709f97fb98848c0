"""One torch intra-op thread for the port's CPU tests.

The plain versions of the kernels run long loops of small torch ops.  The
test workers share the machine's cores with each other and with XLA's
thread pools, and torch's intra-op threads then only wait on each other:
under that load a golden GENERIC archive took 10 s to decode and encode
with 8 threads and 0.9 s with one.  A test module of the port imports this
fixture (pytest puts tests/ on the path); it sets one thread for the
module and restores the count afterwards."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
