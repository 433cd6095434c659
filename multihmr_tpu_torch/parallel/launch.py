"""Run a function on ``n`` ranks of one machine, as ``torch.multiprocessing``
spawned processes joined by a ``file://`` rendezvous (no port to pick, so
several worlds can run side by side).

Each rank initialises the default process group (gloo by default: the CPU,
or several ranks sharing one card), limits its threads, calls
``fn(rank, world_size, *args)`` and saves what it returns; :func:`run_ranks`
(or :class:`Ranks`, which returns at once) gives those values in rank order. A rank that raises fails the whole run,
in the caller. ``torchrun`` launches the training CLI the same way, one rank
per device, through ``init_from_env``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def init_from_env(backend: str) -> None:
    """The default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def _entry(rank, fn, world, workdir, backend, threads, timeout_s, args):
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``fn(rank, world_size, *args)`` started on ``world_size`` spawned ranks;
    :meth:`results` waits for them. ``fn`` must be a module-level function
    of an importable module (the ranks import it)."""

    def __init__(self, fn, world_size: int, args=(), backend: str = "gloo", threads: int = 1,
                 timeout_s: float = 600.0):
        import torch.multiprocessing as mp

        self.world_size = world_size
        self._dir = tempfile.mkdtemp(prefix="mhmr_ranks_")
        self._ctx = mp.start_processes(
            _entry, args=(fn, world_size, self._dir, backend, threads, timeout_s, tuple(args)),
            nprocs=world_size, start_method="spawn", join=False)

    def results(self) -> list:
        """Wait for every rank; their return values in rank order (a rank that
        raised raises here)."""
        try:
            while not self._ctx.join():
                pass
            return [torch.load(os.path.join(self._dir, f"result_{r}.pt"), weights_only=False)
                    for r in range(self.world_size)]
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)


def run_ranks(fn, world_size: int, args=(), backend: str = "gloo", threads: int = 1,
              timeout_s: float = 600.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks; their
    return values (through ``torch.save``), in rank order."""
    return Ranks(fn, world_size, args, backend, threads, timeout_s).results()
