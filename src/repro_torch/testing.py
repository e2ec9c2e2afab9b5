"""What the port's tests share about the processes they run in.

:func:`pin_cpu_threads` sizes torch's CPU thread pools to this process's
share of the host: the test runner starts several worker processes
(pytest-xdist's ``-n``), and torch's default of one intra-op thread a core
in each of them asks for several times the cores there are. Each
``tests/test_torch_*.py`` calls it once when it is imported. A worker
imports every test file while it collects them, so the first port test
module that a worker imports pins torch in that whole worker, for every
test it then runs. :func:`thread_env` gives the same
count to a subprocess a test starts, through the environment, which
``torch.set_num_threads`` does not reach.
"""
from __future__ import annotations

import os


def cpu_threads() -> int:
    """``os.cpu_count()`` over the number of test workers (pytest-xdist's
    ``PYTEST_XDIST_WORKER_COUNT``, 1 without it), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


def pin_cpu_threads() -> int:
    """Set torch's intra-op and inter-op thread counts to :func:`cpu_threads`
    and return it. The inter-op pool is fixed once inter-op work has begun
    (or an earlier call has set it): it is then left as it is."""
    import torch

    n = cpu_threads()
    torch.set_num_threads(n)
    if torch.get_num_interop_threads() != n:
        try:
            torch.set_num_interop_threads(n)
        except RuntimeError:
            pass
    return n


def thread_env(env: dict | None = None) -> dict:
    """A copy of ``env`` (``os.environ`` by default) with ``OMP_NUM_THREADS``
    and ``MKL_NUM_THREADS`` at :func:`cpu_threads`, for a subprocess."""
    n = str(cpu_threads())
    return {**(os.environ if env is None else env), "OMP_NUM_THREADS": n, "MKL_NUM_THREADS": n}
