"""One torch thread in each test process of the port's tests.

Tier-1 runs the suite in six xdist workers on the CPU. Torch's default
intra-op pool holds a thread a core in each worker: on 8 cores the six
workers kept a load average of 24-28, and the port's files took 5,934 s
of worker time; at one thread, 2,170 s. The port's test modules import
this module, so that every worker, and a file run alone, computes with
one thread. The tiny models gain nothing from more (the subprocess case
of ``test_torch_slice.py`` takes 19-20 s alone at 1 and at 8 threads).
One thread also fixes the order of every CPU reduction, and so the bits
of a test's result, whatever the machine's core count.

``TEST_ENV`` is the environment to give a child process (a script under
test, a spawned rank): the same one thread there. ``default_threads``
runs a block at torch's default thread count, for a reference computed
as the test was written (see ``tests/test_torch_ddp.py``).
"""
import contextlib
import os

import torch

DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)
TEST_ENV = dict(os.environ, OMP_NUM_THREADS='1')


@contextlib.contextmanager
def default_threads():
    """Within: torch's default thread count of this process."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(1)


def test_port_tests_compute_with_one_torch_thread():
    assert torch.get_num_threads() == 1
    assert TEST_ENV['OMP_NUM_THREADS'] == '1'
