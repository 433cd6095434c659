"""``utils/profiling.py`` of the port against the JAX package's.

The cases of tests/test_profiling.py, for the port's harness:
``Timer.summary`` equal to the JAX one on the same spans; ``latency_stats``'
keys and its ``on_pair`` hook; its chains (the port has no jaxpr to inspect,
so the calls themselves are counted and their inputs traced back to the
previous outputs); ``device_op_table`` on a CPU ``torch.profiler`` trace,
and on one synthetic trace against the JAX function; ``busy_ms``.
"""

import gzip
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multihmr_tpu.utils import profiling as jprof
from multihmr_tpu_torch.utils import profiling as tprof
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


def test_timer_summary_matches_jax():
    spans = list(np.random.default_rng(0).uniform(1e-4, 3e-2, size=7))
    a, b = jprof.Timer("t"), tprof.Timer("t")
    a.spans, b.spans = list(spans), list(spans)
    assert b.summary() == a.summary()
    assert str(b) == str(a)
    assert tprof.Timer().summary() == jprof.Timer().summary() == {}
    with b:
        pass
    assert b.summary()["n"] == 8 and b.summary()["p50_ms"] >= 0.0


def test_latency_stats_basic_and_on_pair():
    calls = []
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))

    def fn(w, x):
        return {"y": torch.tanh(x @ w)}

    x = torch.ones((8, 64))
    st = tprof.latency_stats(fn, (w, x), iters=2, repeats=4, on_pair=calls.append)
    assert set(st) == {"p50_ms", "min_ms", "iters"}
    assert st["iters"] == 2
    assert np.isfinite(st["p50_ms"]) and np.isfinite(st["min_ms"])
    assert st["p50_ms"] >= 1e-6 and st["min_ms"] >= 1e-6  # the JAX clamp
    # the provisional hook fired exactly once (after the 3rd pair), with ms
    assert len(calls) == 1 and np.isfinite(calls[0])


@pytest.mark.parametrize("iters,repeats", [(1, 2), (3, 4)])
def test_latency_stats_iterations_are_chained(iters, repeats):
    """Two warm-up chains of 2·iters, then per repeat a chain of iters and
    one of 2·iters: 2·2·iters + repeats·3·iters calls. Within a chain each
    call's input is the original perturbed by 1e-12 times the sum of every
    earlier output of the chain (the last float argument; the int one is
    left alone), so no call can be hoisted; a new chain starts from the
    original."""
    seen = []
    big = 2.0 ** 40  # the outputs' sum, times 1e-12, is visible in fp32

    def fn(idx, x):
        seen.append(x.clone())
        return {"y": torch.full_like(x, big), "n": idx}

    idx = torch.arange(4)
    x = torch.zeros((2, 2))
    tprof.latency_stats(fn, (idx, x), iters=iters, repeats=repeats)
    assert len(seen) == 2 * 2 * iters + repeats * 3 * iters
    chains = [2 * iters] * 2 + [iters, 2 * iters] * repeats
    per_call = (big * 4 + float(idx.sum())) * 1e-12  # one output's sum, scaled
    i = 0
    for n in chains:
        for k in range(n):
            want = torch.full((2, 2), np.float32(k * per_call))
            torch.testing.assert_close(seen[i], want, rtol=1e-6, atol=0)
            i += 1


def _cpu_ops(runs):
    a = torch.ones((64, 64))
    for _ in range(runs):
        for _ in range(3):
            a = torch.mm(a, a) / 64.0
        torch.relu(a)


def test_device_op_table_cpu_trace(tmp_path):
    """A CPU trace has no kernel events: every complete event counts, as the
    JAX function does on a CPU backend; totals and counts divide by runs."""
    runs = 2
    with tprof.profile_trace(str(tmp_path)) as prof:
        _cpu_ops(runs)
    assert prof is not None
    table = tprof.device_op_table(str(tmp_path), top=50, runs=runs)
    ms = [row[1] for row in table]
    assert ms == sorted(ms, reverse=True) and len(table) > 0
    names = {name: (t, c) for name, t, c in table}
    assert names["aten::mm"][1] == 3 and names["aten::relu"][1] == 1
    # against a count of the trace itself
    (trace,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    events = json.load(open(tmp_path / trace))["traceEvents"]
    mm = [e for e in events if e.get("ph") == "X" and e["name"] == "aten::mm"]
    assert len(mm) == 3 * runs
    assert names["aten::mm"][0] == pytest.approx(sum(e["dur"] for e in mm) / runs / 1e3)
    # a trace file works as well as its directory
    assert tprof.device_op_table(str(tmp_path / trace), top=50, runs=runs) == table


def test_device_op_table_matches_jax_on_one_trace(tmp_path):
    """The same complete events through both functions: the JAX one reads
    them from its profiler layout, the port's from a Chrome trace file. A
    trace with CUDA kernel events keeps only those in the port's table."""
    rng = np.random.default_rng(1)
    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "host"}}]
    for i in range(40):
        events.append({"ph": "X", "name": f"op{i % 7}", "pid": 1, "tid": 1,
                       "ts": float(i * 100), "dur": float(rng.integers(1, 90))})
    jdir = tmp_path / "jax" / "plugins" / "profile" / "run0"
    jdir.mkdir(parents=True)
    with gzip.open(jdir / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    (tmp_path / "torch").mkdir()
    with open(tmp_path / "torch" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    for top, runs in ((25, 1), (4, 3)):
        want = jprof.device_op_table(str(tmp_path / "jax"), top=top, runs=runs)
        got = tprof.device_op_table(str(tmp_path / "torch"), top=top, runs=runs)
        assert got == want
    events.append({"ph": "X", "cat": "kernel", "name": "flash", "pid": 0, "tid": 7,
                   "ts": 5.0, "dur": 250.0})
    with open(tmp_path / "torch" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    assert tprof.device_op_table(str(tmp_path / "torch"), runs=2) == [("flash", 0.125, 0)]


def test_busy_ms_is_the_union_of_kernel_intervals():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = lambda s, e, d=cuda: SimpleNamespace(  # noqa: E731
        time_range=SimpleNamespace(start=s, end=e), device_type=d)
    events = [ev(0, 100), ev(50, 150), ev(300, 400), ev(120, 130), ev(0, 10_000, cpu)]
    assert tprof.busy_ms(events) == pytest.approx((150 + 100) / 1e3)
    assert tprof.busy_ms([]) == 0.0
