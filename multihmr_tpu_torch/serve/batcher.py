"""Dynamic request batching for serving (``multihmr_tpu/serve/batcher.py``).

The reference serves one image per call (app.py ``infer``, demo.py loop).
A card reaches its throughput only when a batch is full, so
:class:`DynamicBatcher` coalesces single-image requests into one
fixed-shape batch program:

  * one batch shape ``[B, S, S, 3]`` for every batch, so every kernel runs
    at shapes warmed up once;
  * a worker thread coalesces concurrent requests: it waits at most
    ``max_delay_ms`` after the first pending request, then pads the batch to
    capacity (dead slots carry zeros and are dropped on the way out);
  * two-deep pipelining: batch *i+1* is assembled and DISPATCHED before
    batch *i*'s host-side extraction. ``batch_fn`` only enqueues work on
    the card's stream (upload, forward, the device→host copies of the
    results into pinned memory, an event after them) and returns; the
    card runs batch *i+1* while ``extract_fn`` waits on batch *i*'s event
    and builds its results, so the card does not idle between batches;
  * per-request futures so any number of frontend threads (HTTP handlers)
    block only on their own result.

Everything that touches the card runs on the worker thread, warm-up
included (:meth:`DynamicBatcher.warmup`): PyTorch keeps grad mode, cuBLAS
handles and workspaces per thread, so the thread that serves is the one
that was warmed. This module itself is numpy and threading; ``batch_fn``
and ``extract_fn`` carry the device code (``serve/server.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np


class QueueFull(RuntimeError):
    """Raised by :meth:`DynamicBatcher.submit` when the bounded queue is at
    capacity — the load-shed signal (HTTP 429 upstream). ``retry_after_s``
    estimates when the current backlog will have drained."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"request queue full ({depth} pending) — shedding load; "
            f"retry in ~{retry_after_s:.1f}s"
        )
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """Raised when a request aged past the batcher deadline before it could
    be dispatched (HTTP 503 upstream): under overload it is strictly better
    to fail a stale request fast than to burn a device slot computing a
    result its client has stopped waiting for."""


@dataclass
class _Request:
    x: np.ndarray  # [S, S, 3] wire pixels or normalized
    K: np.ndarray  # [3, 3]
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    t_enqueue: float = field(default_factory=time.perf_counter)


class BatcherStats:
    """Thread-safe rolling serving stats (exposed at GET /stats).

    Besides request latency, tracks the worker's per-batch phase walls —
    ``dispatch_ms`` (pad + host→device upload + enqueueing the forward and
    the readback) and ``extract_ms`` (the wait for the readback's event +
    per-request split) — so a load
    test can attribute throughput to upload vs compute vs readback instead
    of guessing (the phases share one serial worker thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batch_size_hist: dict = {}
        self.latencies_ms: List[float] = []
        self.dispatch_ms: List[float] = []
        self.extract_ms: List[float] = []
        self.shed_queue_full = 0
        self.shed_deadline = 0

    def count_shed(self, kind: str):
        with self._lock:
            setattr(self, "shed_" + kind, getattr(self, "shed_" + kind) + 1)

    def record(self, batch_size: int, latencies_ms: List[float]):
        with self._lock:
            self.requests += batch_size
            self.batches += 1
            self.batch_size_hist[batch_size] = (
                self.batch_size_hist.get(batch_size, 0) + 1
            )
            self.latencies_ms.extend(latencies_ms)
            if len(self.latencies_ms) > 10_000:
                self.latencies_ms = self.latencies_ms[-5_000:]

    def record_phase(self, name: str, ms: float):
        with self._lock:
            lst = getattr(self, name + "_ms")
            lst.append(ms)
            if len(lst) > 10_000:
                del lst[:5_000]

    @staticmethod
    def _pcts(values: List[float]):
        if not values:
            return None
        a = np.asarray(values)
        return {
            "p50": round(float(np.percentile(a, 50)), 2),
            "p95": round(float(np.percentile(a, 95)), 2),
            "max": round(float(a.max()), 2),
        }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "batches": self.batches,
                "batch_size_hist": dict(sorted(self.batch_size_hist.items())),
                "mean_batch_size": (
                    round(self.requests / self.batches, 2) if self.batches else 0
                ),
                "latency_ms": self._pcts(self.latencies_ms),
                "dispatch_ms": self._pcts(self.dispatch_ms),
                "extract_ms": self._pcts(self.extract_ms),
                "shed": {
                    "queue_full": self.shed_queue_full,
                    "deadline": self.shed_deadline,
                },
            }


class DynamicBatcher:
    """Coalesce single-image requests into fixed-shape device batches.

    Args:
      batch_fn: ``(x [B,S,S,3], K [B,3,3]) -> handle`` — enqueues the
        batch's work on the card and returns without waiting for it. Called
        with FULL batches only, always on the worker thread.
      extract_fn: ``(handle, n_valid) -> list`` of per-request results
        (host-side; runs pipelined against the next batch's device step).
      max_batch: the compiled batch capacity B.
      max_delay_ms: how long the worker waits for more requests after the
        first one arrives (the latency/throughput knob; 0 = never wait).
      wire_dtype: if set, ``submit`` rejects images of any other dtype. A
        coalesced batch takes its buffer dtype from its FIRST request, so
        mixing uint8-wire and pre-normalized fp32 submissions in one batch
        would silently corrupt whichever requests lose the race (unsafe
        fp32→u8 cast, or raw u8 pixels taken as normalized ones) — fail
        fast instead.
      max_queue: bounded-queue overload policy (0 = unbounded). When the
        pending queue is at capacity, ``submit`` sheds the request with
        :class:`QueueFull` (→ HTTP 429 + Retry-After upstream) instead of
        letting queueing delay grow without bound: the chip's throughput is
        a hard wire/compute ceiling, so beyond-capacity offered load MUST
        fail fast — every queued request past the ceiling only adds latency
        for everyone behind it.
      deadline_s: per-request dispatch deadline (0 = none). A request that
        ages past this while still queued is failed with
        :class:`DeadlineExceeded` at dequeue time — never dispatched — so a
        burst's stale tail doesn't waste device batches on clients that have
        already timed out.
    """

    def __init__(
        self,
        batch_fn: Callable,
        extract_fn: Callable,
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
        wire_dtype=None,
        max_queue: int = 0,
        deadline_s: float = 0.0,
    ):
        self.batch_fn = batch_fn
        self.extract_fn = extract_fn
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.wire_dtype = None if wire_dtype is None else np.dtype(wire_dtype)
        self.max_queue = int(max_queue)
        self.deadline_s = float(deadline_s)
        # EMA of one batch's dispatch→resolve wall — the Retry-After estimate
        self._cycle_ema: Optional[float] = None
        self.stats = BatcherStats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._warm_q: "queue.Queue[_Request]" = queue.Queue()  # warm-up batches
        self._stop = threading.Event()
        # serializes submit's {closed-check + enqueue} against close's
        # {stop + drain}: without it a request could land in the queue after
        # the drain and block its caller for the full timeout
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- frontend
    def warmup(self, x_shape: tuple, dtype=None, timeout: float = 1800.0):
        """Run one dummy full batch on the worker thread and wait for it.

        ``x_shape``/``dtype``: one request's image shape and WIRE dtype
        (must match real submissions; defaults to the batcher's
        ``wire_dtype``, else fp32). Without this, the first real requests
        pay the first-use costs inside their submit() wait: the kernels'
        build, the first launches at these shapes, and the worker thread's
        own cuBLAS handle and workspace. The batch runs on the worker
        thread, outside the stats path; its errors raise here.
        """
        if dtype is None:
            dtype = self.wire_dtype if self.wire_dtype is not None else np.float32
        x = np.zeros((self.max_batch,) + tuple(x_shape), dtype)
        K = np.tile(np.eye(3, dtype=np.float32), (self.max_batch, 1, 1))
        req = _Request(x, K)
        with self._close_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher closed")
            self._warm_q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("warm-up batch timed out")
        if req.error is not None:
            raise req.error

    def submit(self, x: np.ndarray, K: np.ndarray, timeout: float = 60.0):
        """Block until this request's result is ready; raises on worker error."""
        x = np.asarray(x)
        if self.wire_dtype is not None and x.dtype != self.wire_dtype:
            raise TypeError(
                f"batcher wire dtype is {self.wire_dtype}, got {x.dtype} — "
                "a mixed-dtype coalesced batch would corrupt results"
            )
        req = _Request(x, np.asarray(K))
        with self._close_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher closed")  # fail fast on shutdown
            depth = self._q.qsize()
            if self.max_queue and depth >= self.max_queue:
                self.stats.count_shed("queue_full")
                cycle = self._cycle_ema if self._cycle_ema else 1.0
                batches_ahead = (depth + self.max_batch - 1) // self.max_batch
                raise QueueFull(depth, retry_after_s=batches_ahead * cycle)
            self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("inference request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        # Fail any requests still queued (never dispatched): their submit()
        # callers would otherwise block for the full timeout during shutdown.
        # Under the lock: no new request can be enqueued after this drain.
        with self._close_lock:
            for q in (self._q, self._warm_q):
                while True:
                    try:
                        req = q.get_nowait()
                    except queue.Empty:
                        break
                    req.error = RuntimeError("batcher closed")
                    req.done.set()

    # --------------------------------------------------------------- worker
    def _collect(self, first_timeout: float = 0.1) -> List[_Request]:
        """Block up to ``first_timeout`` for the first request, then coalesce
        up to max_batch for at most max_delay_ms."""
        try:
            first = self._q.get(timeout=first_timeout)
        except queue.Empty:
            return []
        reqs = [first]
        deadline = time.perf_counter() + self.max_delay_ms / 1e3
        while len(reqs) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return reqs

    def _expire(self, reqs: List[_Request]) -> List[_Request]:
        """Fail queued requests that aged past the deadline (never dispatch
        them); returns the still-live subset."""
        if not self.deadline_s:
            return reqs
        now = time.perf_counter()
        live = []
        for r in reqs:
            waited = now - r.t_enqueue
            if waited > self.deadline_s:
                self.stats.count_shed("deadline")
                r.error = DeadlineExceeded(
                    f"request waited {waited*1e3:.0f} ms in queue "
                    f"(deadline {self.deadline_s*1e3:.0f} ms) — shed before "
                    f"dispatch"
                )
                r.done.set()
            else:
                live.append(r)
        return live

    def _dispatch(self, reqs: List[_Request]):
        """Pad to capacity and launch the device program (async)."""
        B = self.max_batch
        x = np.zeros((B,) + reqs[0].x.shape, reqs[0].x.dtype)
        K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        for i, r in enumerate(reqs):
            x[i] = r.x
            K[i] = r.K
        t0 = time.perf_counter()
        out = self.batch_fn(x, K)  # enqueues on the card's stream, returns early
        self.stats.record_phase("dispatch", (time.perf_counter() - t0) * 1e3)
        return out

    def _resolve(self, reqs: List[_Request], device_out, t_dispatch=None):
        """Host-side extraction + future completion for a dispatched batch."""
        try:
            t0 = time.perf_counter()
            results = self.extract_fn(device_out, len(reqs))
            now = time.perf_counter()
            self.stats.record_phase("extract", (now - t0) * 1e3)
            lats = []
            for r, res in zip(reqs, results):
                r.result = res
                lats.append((now - r.t_enqueue) * 1e3)
                r.done.set()
            self.stats.record(len(reqs), lats)
            if t_dispatch is not None:  # batch cycle wall → Retry-After EMA
                cycle = now - t_dispatch
                self._cycle_ema = (
                    cycle if self._cycle_ema is None
                    else 0.8 * self._cycle_ema + 0.2 * cycle
                )
        except BaseException as e:  # propagate to the waiting frontends
            for r in reqs:
                r.error = e
                r.done.set()

    def _warm(self, req: _Request):
        """A warm-up batch (:meth:`warmup`), run to its end on this thread."""
        try:
            self.extract_fn(self.batch_fn(req.x, req.K), 0)
        except BaseException as e:
            req.error = e
        req.done.set()

    def _run(self):
        pending: Optional[tuple] = None  # (reqs, device_out, t_dispatch)
        while not self._stop.is_set():
            if pending is None:
                try:
                    self._warm(self._warm_q.get_nowait())
                except queue.Empty:
                    pass
            # With a batch in flight, only PEEK for follow-up work (1 ms):
            # blocking the full 100 ms here would delay resolving the
            # finished batch by that much on every idle gap — pipelining is
            # for sustained load, where the queue is non-empty anyway.
            reqs = self._expire(
                self._collect(0.001 if pending is not None else 0.1)
            )
            if reqs:
                try:
                    t_dispatch = time.perf_counter()
                    out = self._dispatch(reqs)
                except BaseException as e:
                    for r in reqs:
                        r.error = e
                        r.done.set()
                    reqs = None
                    out = None
            else:
                out = None
            # resolve the PREVIOUS batch while this one computes on the card
            if pending is not None:
                self._resolve(*pending)
                pending = None
            if reqs:
                pending = (reqs, out, t_dispatch)
            elif out is None and pending is None and self._q.empty():
                continue
        if pending is not None:
            self._resolve(*pending)
