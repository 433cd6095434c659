"""One small, fixed torch thread pool for the port's tests.

Every ``tests/test_torch_*.py`` imports this module, so a file run alone
gets the same pool as in the suite, and xdist, which imports every test
module at collection, fixes it in each worker before any case runs. Six
workers sharing the cores, each with torch's default pool of one thread a
core, spend most of their CPU contending; one thread each is faster.

The tiny CPU forwards' outputs depend on the pool: another thread count
rounds the sums otherwise, and the 2-D projection of a vertex near the
camera plane makes a pixel of that. So every process whose outputs a test
compares bitwise runs the same pool: a child process that a port test
starts takes :func:`child_env`, and the ranks that
``parallel/launch.py::run_ranks`` spawns set one thread themselves (its
default ``threads=1``). The worker's own ``os.environ`` is left as it is:
the JAX tests' children inherit it, and torch's pool is not XLA's.
"""

import os

import torch

THREADS = 1

torch.set_num_threads(THREADS)


def child_env() -> dict:
    """``os.environ`` for a child process of a port test, with this pool."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS))
