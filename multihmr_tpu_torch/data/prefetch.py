"""Host-side data-loading parallelism for the training loop
(``multihmr_tpu/data/prefetch.py``, a copy held equal to it by
``tests/test_torch_data.py``).

A bounded, ORDER-PRESERVING thread map over batch builders:

- threads, not processes: the per-batch work (JPEG/PNG decode, PIL resize,
  numpy collate) releases the GIL in its hot loops, and thread workers can
  hand numpy arrays to the trainer with zero pickling/IPC cost;
- bounded in-flight window: torch's loader keeps ``2 * num_workers``
  batches outstanding for the same reason — an unbounded map would
  materialize the whole epoch in host RAM;
- ordered yield: the consumer (Trainer.fit) must see batches in schedule
  order so runs are comparable across ``num_workers`` settings.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def bounded_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    num_workers: int,
    prefetch: int = 2,
) -> Iterator[R]:
    """Yield ``fn(item)`` in input order, computed by ``num_workers``
    threads with at most ``num_workers + prefetch`` calls in flight.

    ``num_workers <= 0`` degrades to a plain serial map (the reference's
    ``num_workers=0`` in-process path, torch semantics). Exceptions from
    ``fn`` propagate to the consumer at the failing item's position, after
    which iteration stops (remaining in-flight work is abandoned to the
    executor's shutdown).
    """
    if num_workers <= 0:
        for item in items:
            yield fn(item)
        return

    it = iter(items)
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        window: collections.deque = collections.deque()

        def _fill():
            while len(window) < num_workers + prefetch:
                try:
                    window.append(ex.submit(fn, next(it)))
                except StopIteration:
                    return

        _fill()
        while window:
            out = window.popleft().result()  # raises the worker's exception
            _fill()
            yield out
