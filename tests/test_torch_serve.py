"""The port's serving path (``multihmr_tpu_torch/serve``, ``cli/serve.py``)
on the CPU: the cases of tests/test_serve.py on the port's batcher and
server (all but the profiler's op table, M12), the port's server against
the JAX server on the same tiny weights and PNGs, and data-parallel serving
(``mesh=``, a list of devices: ``[cpu, cpu]`` here) against the JAX
server on its 8-device data mesh.

The tiny model is tests/test_torch_model.py's: ``TinyConfig`` (ViT 32 wide,
2 deep, 56 x 56, K = 4 slots) in fp32 with the "tempered" weights of
``make_reference_state_dict`` through the JAX converter and
``params_from_jax``. The two servers' JSON persons are held to that test's
``TOLS["tempered"]`` (relative to each field's largest magnitude) with
equal counts; ``transl_pelvis`` to the joints' (j3d) tolerance.
``cli/serve.py --artifact`` serves an artifact that
``tools/export_model.py`` exports on the CPU from the tiny configuration.
"""

import io
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.serve import DeadlineExceeded, DynamicBatcher, QueueFull, make_server
from multihmr_tpu_torch.serve.server import build_batched_infer
from tests.test_checkpoint import TinyConfig, make_reference_state_dict
from tests.test_torch_model import TOLS
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

S = 56
K_TINY = np.asarray([[100.0, 0, S / 2], [0, 100.0, S / 2], [0, 0, 1]], np.float32)


def _tempered_state_dict(cfg):
    sd = make_reference_state_dict(cfg, np.random.default_rng(0))
    return {k: (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
            if k.endswith("weight") and v.ndim >= 2 else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX params, JAX model, port model) on the same tempered weights."""
    import jax

    from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
    from multihmr_tpu.io.checkpoint import convert_torch_checkpoint
    from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR

    cfg = TinyConfig(img_size=S, max_people=4, person_center="j5", compute_dtype="float32")
    params = convert_torch_checkpoint({"model_state_dict": _tempered_state_dict(cfg)}, cfg)
    jbm = jsynthetic()
    names = [f"j{i}" for i in range(jbm.num_output_joints)]
    jm = JMultiHMR(cfg, jbm, person_center_joint_names=names)
    net = MultiHMRNet(cfg)
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net.eval(),
                  person_center_joint_names=names)
    return cfg, params, jm, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[3]


def _png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, payload, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/infer{query}", data=payload,
                                 method="POST")
    return urllib.request.urlopen(req, timeout=120)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv.server_address[1]


def test_dynamic_batcher_coalesces_and_matches_single(model):
    def batch_fn(x, K):
        with torch.inference_mode():
            out = model.forward(torch.from_numpy(x), torch.from_numpy(K), det_thresh=0.1)
        return model.start_persons(out)

    batcher = DynamicBatcher(batch_fn, lambda p, n: p.persons()[:n], max_batch=4,
                             max_delay_ms=200.0)
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(S, S, 3)).astype(np.float32) for _ in range(6)]
    results = [None] * len(xs)

    def client(i):
        results[i] = batcher.submit(xs[i], K_TINY)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    batcher.close()

    # coalescing happened: 6 requests in a 200 ms window with capacity 4
    snap = batcher.stats.snapshot()
    assert snap["requests"] == 6
    assert max(snap["batch_size_hist"]) > 1, snap
    # each result equals the same image alone in slot 0 of the same batch
    for i in (0, 3, 5):
        x_pad = np.zeros((4, S, S, 3), np.float32)
        x_pad[0] = xs[i]
        with torch.inference_mode():
            single = model.extract_persons(model.forward(
                torch.from_numpy(x_pad), torch.from_numpy(np.tile(K_TINY, (4, 1, 1))),
                det_thresh=0.1))[0]
        assert len(results[i]) == len(single) > 0
        for a, b in zip(results[i], single):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)


def test_batcher_error_propagates():
    def batch_fn(x, K):
        raise RuntimeError("device exploded")

    batcher = DynamicBatcher(batch_fn, lambda o, n: [], max_batch=2, max_delay_ms=1.0)
    with pytest.raises(RuntimeError, match="device exploded"):
        batcher.submit(np.zeros((8, 8, 3), np.float32), np.eye(3))
    batcher.close()


def test_batcher_close_fails_queued_requests():
    """Requests still queued at close() are failed promptly, not left to
    block their submit() callers until the full request timeout."""
    release = threading.Event()

    def slow_batch_fn(x, K):
        release.wait(10)
        return x

    batcher = DynamicBatcher(slow_batch_fn, lambda o, n: [None] * n, max_batch=1,
                             max_delay_ms=0.0)
    errors = {}

    def client(i):
        try:
            batcher.submit(np.zeros((4, 4, 3), np.float32), np.eye(3), timeout=30.0)
        except BaseException as e:
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # let the worker pick up request 0 and block
    t0 = time.perf_counter()
    closer = threading.Thread(target=batcher.close)
    closer.start()
    time.sleep(0.2)
    release.set()  # un-block the in-flight batch so close() can join
    closer.join(10)
    for t in threads:
        t.join(10)
    assert time.perf_counter() - t0 < 10  # nowhere near the 30 s timeout
    assert sum(isinstance(e, RuntimeError) for e in errors.values()) >= 2, errors


def test_batcher_warmup_runs_on_the_worker_thread():
    """warmup() runs its full batch on the thread that serves, outside the
    stats, and raises the batch's error in the caller."""
    seen = []

    def batch_fn(x, K):
        seen.append((threading.current_thread().name, x.shape, x.dtype))
        return x

    batcher = DynamicBatcher(batch_fn, lambda o, n: [None] * n, max_batch=3,
                             max_delay_ms=0.0, wire_dtype=np.uint8)
    try:
        batcher.warmup((4, 4, 3))
        batcher.submit(np.zeros((4, 4, 3), np.uint8), np.eye(3))
        assert seen[0] == (batcher._worker.name, (3, 4, 4, 3), np.uint8)
        assert seen[1][0] == batcher._worker.name != threading.current_thread().name
        assert batcher.stats.snapshot()["requests"] == 1
    finally:
        batcher.close()

    def broken(x, K):
        raise RuntimeError("no kernel")

    batcher = DynamicBatcher(broken, lambda o, n: [], max_batch=2, max_delay_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="no kernel"):
            batcher.warmup((4, 4, 3))
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.warmup((4, 4, 3))


def test_batch_fn_runs_without_autograd(model):
    """The worker thread does not inherit the caller's inference mode:
    batch_fn takes its own, so no batch records a graph over the weights."""
    batcher, preprocess = build_batched_infer(model, max_batch=2, det_thresh=0.1,
                                              max_delay_ms=1.0)
    try:
        assert torch.is_grad_enabled()
        pending = batcher.batch_fn(np.zeros((2, S, S, 3), np.uint8),
                                   np.tile(K_TINY, (2, 1, 1)))
        assert all(not h.requires_grad for h in pending.host.values())
        x, K, pil = preprocess(np.zeros((30, 40, 3), np.uint8))
        assert x.dtype == np.uint8 and x.shape == (S, S, 3) and pil.size == (40, 30)
    finally:
        batcher.close()


def test_http_server_end_to_end(model):
    srv, batcher = make_server(model, port=0, max_batch=4, det_thresh=0.1, max_delay_ms=50.0)
    port = _serve(srv)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        img = np.random.default_rng(1).uniform(0, 255, size=(80, 64, 3)).astype(np.uint8)
        payload = _png(img)
        out = [None] * 3

        def post(i):
            with _post(port, payload) as r:
                out[i] = json.load(r)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(o is not None and "persons" in o for o in out)
        # identical inputs → identical outputs through the batch
        assert out[0] == out[1] == out[2] and out[0]["count"] > 0
        # ?render=1: a PNG of the original size, its person count in a header
        from PIL import Image

        with _post(port, payload, "?render=1") as r:
            assert r.headers["Content-Type"] == "image/png"
            assert int(r.headers["X-Person-Count"]) == out[0]["count"]
            assert np.asarray(Image.open(io.BytesIO(r.read()))).shape == img.shape
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            snap = json.load(r)
        assert snap["requests"] >= 4
    finally:
        srv.shutdown()
        batcher.close()


def test_server_matches_jax_server(pair):
    """The port's server and the JAX server, same weights and PNGs: the same
    persons within the forward's parity tolerance."""
    from multihmr_tpu.serve import make_server as jmake_server

    cfg, params, jm, tm = pair
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
              for hw in ((60, 80), (80, 60), (56, 56))]
    got = {}
    for name, (srv, batcher) in (
            ("jax", jmake_server(jm, params, port=0, max_batch=4, det_thresh=0.1,
                                 max_delay_ms=5.0)),
            ("torch", make_server(tm, port=0, max_batch=4, det_thresh=0.1, max_delay_ms=5.0))):
        port = _serve(srv)
        try:
            got[name] = []
            for img in images:
                with _post(port, _png(img)) as r:
                    got[name].append(json.load(r))
        finally:
            srv.shutdown()
            batcher.close()
    tol = TOLS["tempered"]
    fields = {"score": tol["scores"], "loc": tol["loc"], "transl": tol["transl"],
              "transl_pelvis": tol["j3d"]}
    assert sum(r["count"] for r in got["torch"]) > 0
    for a, b in zip(got["jax"], got["torch"]):
        assert a["count"] == b["count"]
        for pa, pb in zip(a["persons"], b["persons"]):
            assert pa["n_j2d"] == pb["n_j2d"]
            for k, t in fields.items():
                va, vb = np.asarray(pa[k], np.float64), np.asarray(pb[k], np.float64)
                err = np.abs(va - vb).max() / max(np.abs(va).max(), 1.0)
                assert err <= t, (k, err)


def test_dp_mesh_serving_matches_single(pair):
    """Data-parallel serving over [cpu, cpu] (each batch of 8 cut into two
    chunks of 4, one replica each): the persons of one request equal the
    JAX data-parallel server's on its 8-device mesh (this file's forward
    parity tolerance) and the port's forward of that image alone."""
    from multihmr_tpu.parallel import make_mesh as jmake_mesh
    from multihmr_tpu.serve.server import build_batched_infer as jbuild

    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD

    cfg, params, jm, tm = pair
    u8 = np.random.default_rng(3).integers(0, 256, size=(S, S, 3), dtype=np.uint8)
    # normalised as the port's server does it on the device
    x = ((torch.from_numpy(u8).float() / 255.0 - torch.from_numpy(IMG_NORM_MEAN))
         / torch.from_numpy(IMG_NORM_STD)).numpy()
    got = {}
    for name, (batcher, _), img in (
            ("jax", jbuild(jm, params, max_batch=8, det_thresh=0.1, max_delay_ms=1.0,
                           mesh=jmake_mesh(8, model_parallel=1), wire="f32"), x),
            ("torch", build_batched_infer(tm, max_batch=8, det_thresh=0.1, max_delay_ms=1.0,
                                          mesh=["cpu", "cpu"]), u8)):
        try:
            got[name] = batcher.submit(img, K_TINY)
        finally:
            batcher.close()
    with torch.inference_mode():
        alone = tm.extract_persons(tm.forward(torch.from_numpy(x[None]),
                                              torch.from_numpy(K_TINY[None]), det_thresh=0.1))[0]
    assert len(got["torch"]) == len(got["jax"]) == len(alone) > 0
    tol = TOLS["tempered"]["v3d"]
    for g, w, a in zip(got["torch"], got["jax"], alone):
        v = np.asarray(w["v3d"], np.float64)
        assert np.abs(g["v3d"] - v).max() / max(np.abs(v).max(), 1.0) <= tol
        np.testing.assert_allclose(g["v3d"], a["v3d"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_mesh,expected", [(True, [4, 4]), (False, [8])])
def test_server_batch_mode_selection(model, with_mesh, expected):
    """Each batch runs as fused forwards: one of max_batch images on one
    device, one of max_batch / n images per device of a mesh (the JAX
    server asks for "fused" under a mesh and "auto" without; the port has no
    lax.map, so "auto" is fused too)."""
    seen = []
    orig_forward = model.forward

    def spy_forward(x, K, **kw):
        seen.append(x.shape[0])
        return orig_forward(x, K, **kw)

    model.forward = spy_forward
    try:
        batcher, _ = build_batched_infer(model, max_batch=8, det_thresh=0.1, max_delay_ms=1.0,
                                         mesh=["cpu", "cpu"] if with_mesh else None)
        try:
            batcher.submit(np.zeros((S, S, 3), np.uint8), K_TINY)
        finally:
            batcher.close()
    finally:
        del model.forward
    assert seen == expected, seen


def test_u8_wire_matches_host_normalized(model):
    """The uint8 wire (raw pixels, normalized on the device) gives the same
    input as host normalization, hence the same persons."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD

    img = np.random.default_rng(7).integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
    batcher, preprocess = build_batched_infer(model, max_batch=2, det_thresh=0.1,
                                              max_delay_ms=1.0)
    try:
        x_u8, K, _ = preprocess(img)
        assert x_u8.dtype == np.uint8 and batcher.wire_dtype == np.uint8
        got = batcher.submit(x_u8, K)
    finally:
        batcher.close()
    p = preprocess_array(img, S)
    # the server's normalization, bitwise the host's
    dev = (torch.from_numpy(x_u8).float() / 255.0 - torch.from_numpy(IMG_NORM_MEAN)) \
        / torch.from_numpy(IMG_NORM_STD)
    np.testing.assert_array_equal(dev.numpy(), p.x)
    with torch.inference_mode():
        want = model.extract_persons(model.forward(
            torch.from_numpy(p.x)[None], torch.from_numpy(p.K)[None], det_thresh=0.1))[0]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["v3d"], w["v3d"], rtol=1e-4, atol=1e-4)


def test_wire_dtype_mismatch_rejected(model):
    """A batcher enforces one wire dtype (the coalesced buffer takes the
    first request's): the server's uint8 batcher rejects fp32, and a
    batcher built with either dtype rejects the other."""
    batcher, _ = build_batched_infer(model, max_batch=2, det_thresh=0.1, max_delay_ms=1.0)
    try:
        assert batcher.wire_dtype == np.uint8
        with pytest.raises(TypeError, match="wire dtype"):
            batcher.submit(np.zeros((S, S, 3), np.float32), np.eye(3))
    finally:
        batcher.close()
    for wire, other in ((np.uint8, np.float32), (np.float32, np.uint8)):
        batcher = DynamicBatcher(lambda x, K: x, lambda o, n: list(o[:n]), max_batch=2,
                                 max_delay_ms=0.0, wire_dtype=wire)
        try:
            with pytest.raises(TypeError, match="wire dtype"):
                batcher.submit(np.zeros((4, 4, 3), other), np.eye(3))
            assert batcher.submit(np.ones((4, 4, 3), wire), np.eye(3)).dtype == wire
        finally:
            batcher.close()


@pytest.mark.parametrize("kw,match", [
    ({"mesh": object()}, "list of devices"),
    ({"mesh": ["cpu", "cpu"], "max_batch": 3}, "must divide over the 2 devices"),
    ({"mesh": ["cpu"], "forward_fn": lambda x, K: None}, "exclude each other"),
])
def test_unported_server_options_raise(model, kw, match):
    """A data-parallel server's options the JAX server asserts raise."""
    with pytest.raises(ValueError, match=match):
        build_batched_infer(model, **kw)


def test_http_server_json_only(model):
    """json_only: the JSON equals the full server's, ?render=1 is refused
    with 400, and the batch reads back only the JSON fields."""
    img = np.random.default_rng(1).uniform(0, 255, size=(80, 64, 3)).astype(np.uint8)
    answers = {}
    for json_only in (False, True):
        srv, batcher = make_server(model, port=0, max_batch=2, det_thresh=0.1,
                                   max_delay_ms=5.0, json_only=json_only)
        port = _serve(srv)
        try:
            with _post(port, _png(img)) as r:
                answers[json_only] = json.load(r)
            if json_only:
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(port, _png(img), "?render=1")
                assert e.value.code == 400
                pending = batcher.batch_fn(np.zeros((2, S, S, 3), np.uint8),
                                           np.tile(K_TINY, (2, 1, 1)))
                assert set(pending.host) == {
                    "valid", "scores", "loc", "transl", "transl_pelvis", "j2d"}
        finally:
            srv.shutdown()
            batcher.close()
    assert answers[True] == answers[False] and answers[True]["count"] > 0


def test_extract_persons_fields(model):
    """fields= restricts the keys pulled to the host (and only those);
    start_persons gives extract_persons' persons."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, S, S, 3)).astype(np.float32))
    K = torch.from_numpy(K_TINY[None])
    with torch.inference_mode():
        out = model.forward(x, K, det_thresh=0.05)
    persons = model.extract_persons(out, fields=["scores", "loc"])[0]
    full = model.extract_persons(out)[0]
    assert len(persons) == len(full) > 0
    for lean, fat in zip(persons, full):
        assert set(lean) == {"scores", "loc"}
        np.testing.assert_array_equal(lean["loc"], fat["loc"])
    for a, b in zip(model.start_persons(out).persons()[0], full):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_batcher_queue_full_sheds():
    """Bounded-queue load shed: with the worker busy and the queue at
    max_queue, submit() fails fast with QueueFull (+ a Retry-After estimate)."""
    release = threading.Event()
    started = threading.Event()

    def slow_batch_fn(x, K):
        started.set()
        release.wait(10)
        return x

    batcher = DynamicBatcher(slow_batch_fn, lambda o, n: [None] * n, max_batch=1,
                             max_delay_ms=0.0, max_queue=2)
    outcomes = {}

    def client(i):
        try:
            outcomes[i] = batcher.submit(np.zeros((4, 4, 3), np.float32), np.eye(3),
                                         timeout=30.0)
        except BaseException as e:
            outcomes[i] = e

    try:
        t0 = threading.Thread(target=client, args=(0,))
        t0.start()
        assert started.wait(5)  # worker now blocked inside the device call
        backlog = [threading.Thread(target=client, args=(i,)) for i in (1, 2)]
        for t in backlog:
            t.start()
        for _ in range(500):  # wait for both to be genuinely queued
            if batcher._q.qsize() >= 2:
                break
            time.sleep(0.01)
        assert batcher._q.qsize() >= 2
        with pytest.raises(QueueFull) as ei:
            batcher.submit(np.zeros((4, 4, 3), np.float32), np.eye(3))
        assert ei.value.retry_after_s > 0
        release.set()
        t0.join(10)
        for t in backlog:
            t.join(10)
        assert batcher.stats.snapshot()["shed"]["queue_full"] == 1
        assert not isinstance(outcomes[1], BaseException)
        assert not isinstance(outcomes[2], BaseException)
    finally:
        release.set()
        batcher.close()


def test_batcher_deadline_sheds_stale_requests():
    """Requests that age past deadline_s in the queue fail with
    DeadlineExceeded at dequeue time, never dispatched."""
    def slow_batch_fn(x, K):
        time.sleep(0.3)
        return x

    batcher = DynamicBatcher(slow_batch_fn, lambda o, n: [None] * n, max_batch=1,
                             max_delay_ms=0.0, deadline_s=0.1)
    outcomes = {}

    def client(i):
        try:
            outcomes[i] = batcher.submit(np.zeros((4, 4, 3), np.float32), np.eye(3),
                                         timeout=10.0)
        except BaseException as e:
            outcomes[i] = e

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
        oks = [o for o in outcomes.values() if not isinstance(o, BaseException)]
        shed = [o for o in outcomes.values() if isinstance(o, DeadlineExceeded)]
        # one request occupies the 0.3 s batch; the other two wait > 0.1 s
        assert len(oks) == 1 and len(shed) == 2, outcomes
        assert batcher.stats.snapshot()["shed"]["deadline"] == 2
    finally:
        batcher.close()


def test_http_overload_status_codes(model):
    """QueueFull → 429 with a Retry-After header, DeadlineExceeded → 503,
    a worker error → 500 (the shed is injected so the HTTP layer is
    deterministic)."""
    srv, batcher = make_server(model, port=0, max_batch=2, det_thresh=0.1, max_delay_ms=1.0,
                               max_queue=4, deadline_s=5.0)
    port = _serve(srv)
    orig_submit = batcher.submit
    payload = _png(np.zeros((32, 32, 3), np.uint8))

    def raiser(exc):
        def _submit(*a, **k):
            raise exc
        return _submit

    try:
        batcher.submit = raiser(QueueFull(4, retry_after_s=2.3))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, payload)
        assert e.value.code == 429
        assert e.value.headers["Retry-After"] == "2"
        assert json.loads(e.value.read())["retry_after_s"] == 2.3
        batcher.submit = raiser(DeadlineExceeded("stale"))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, payload)
        assert e.value.code == 503
        batcher.submit = raiser(TimeoutError("slow"))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, payload)
        assert e.value.code == 504
        batcher.submit = raiser(RuntimeError("boom"))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, payload)
        assert e.value.code == 500
        batcher.submit = orig_submit  # healthy path still works
        with _post(port, payload) as r:
            assert "persons" in json.load(r)
    finally:
        batcher.submit = orig_submit
        srv.shutdown()
        batcher.close()


# ---- cli/serve.py

def _tiny_factory(mp):
    """``factory``'s named configurations and body model swapped for tiny
    ones through the monkeypatch ``mp``."""
    import multihmr_tpu_torch.factory as factory

    cfg = TinyConfig(img_size=S, max_people=3, person_center="head", compute_dtype="float32")
    mp.setattr(factory, "named_config", lambda name: cfg)
    small = synthetic_body_model(num_joints=55, num_vertices=64, num_extra=21, num_lmk=51)
    mp.setattr(factory, "smplx_like_synthetic", lambda nb: small)


@pytest.fixture
def tiny_factory(monkeypatch):
    _tiny_factory(monkeypatch)


def test_serve_cli_on_the_cpu(tiny_factory):
    from multihmr_tpu_torch.cli import serve

    args = serve.parse_args(["--device", "cpu", "--port", "0", "--det_thresh", "0.0",
                             "--max_batch", "2", "--tp_mode", "ring"])
    assert args.model_name == "multiHMR_672_B" and args.max_batch == 2
    srv, batcher = serve.build_server(args)
    port = _serve(srv)
    try:
        with _post(port, _png(np.zeros((40, 48, 3), np.uint8))) as r:
            assert json.load(r)["count"] == 3
        assert batcher.max_batch == 2 and batcher.stats.snapshot()["requests"] == 1
    finally:
        srv.shutdown()
        batcher.close()


@pytest.mark.parametrize("flags,error,match", [
    (["--dp"], RuntimeError, "no CUDA card"),
    (["--artifact", "exported/672B", "--dp"], ValueError, "mutually exclusive"),
    (["--model_name", "multiHMR_672_L_anny", "--device", "cpu"], ValueError, "Anny"),
    ([], RuntimeError, "no CUDA card"),
])
def test_serve_cli_refusals(flags, error, match, monkeypatch):
    """``--dp`` beside ``--artifact`` and an Anny name raise at start; so
    does --device cuda without a card, with ``--dp`` too (no quiet CPU
    serving)."""
    from multihmr_tpu_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        serve.build_server(serve.parse_args(flags))


# ---- cli/serve.py --artifact (a tools/export_model.py artifact, io/export.py)

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny multiHMR_672_B artifact exported on the CPU at batch 2 with
    det_thresh 0 by ``tools/export_model.py``, once a module."""
    from multihmr_tpu_torch.tools import export_model

    with pytest.MonkeyPatch.context() as mp:
        _tiny_factory(mp)
        return export_model.main(["--model_name", "multiHMR_672_B", "--out",
                                  str(tmp_path_factory.mktemp("artifact") / "a"), "--batch", "2",
                                  "--det_thresh", "0.0", "--device", "cpu"])


@pytest.fixture
def artifact(tiny_factory, exported, tmp_path):
    """A case's own copy of the exported artifact."""
    return shutil.copytree(exported, str(tmp_path / "a"))


def test_serve_cli_artifact_answers(artifact):
    """The server takes the batch, the detection parameters and the weights
    from the artifact and answers a request."""
    from multihmr_tpu_torch.cli import serve

    args = serve.parse_args(["--artifact", artifact, "--device", "cpu", "--port", "0"])
    srv, batcher = serve.build_server(args)
    port = _serve(srv)
    try:
        with _post(port, _png(np.zeros((40, 48, 3), np.uint8))) as r:
            assert json.load(r)["count"] == 3
        assert batcher.max_batch == args.max_batch == 2 and args.det_thresh == 0.0
        assert batcher.stats.snapshot()["requests"] == 1
    finally:
        srv.shutdown()
        batcher.close()


@pytest.mark.parametrize("name,match", [("tiny", "re-export"),
                                        ("multiHMR_672_L_anny", "Anny")])
def test_serve_cli_artifact_name_refused(artifact, name, match):
    """An artifact whose meta name is not a known configuration is refused
    with a hint to re-export; an Anny artifact as an Anny name is."""
    from multihmr_tpu_torch.cli import serve

    meta_path = os.path.join(artifact, "meta.json")
    meta = dict(json.load(open(meta_path)), name=name)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match=match):
        serve.build_server(serve.parse_args(["--artifact", artifact, "--device", "cpu"]))


def test_serve_cli_artifact_warns_on_ignored_flags(artifact, capsys):
    from multihmr_tpu_torch.cli import serve

    args = serve.parse_args(["--artifact", artifact, "--device", "cpu", "--port", "0",
                             "--det_thresh", "0.5", "--nms_kernel_size", "5",
                             "--ckpt", "multiHMR_672_B.pt"])
    srv, batcher = serve.build_server(args)
    srv.server_close()
    batcher.close()
    err = capsys.readouterr().err
    for line in ("--det_thresh=0.5 ignored — the artifact bakes det_thresh=0.0",
                 "--nms_kernel_size=5 ignored — the artifact bakes nms_kernel_size=3",
                 "--max_batch=8 ignored — the artifact bakes batch_size=2",
                 "--ckpt ignored — weights come from the artifact"):
        assert line in err, err


def test_serve_cli_artifact_builds_no_second_net(artifact, monkeypatch):
    """The artifact holds the weights: serving it builds no model with
    weights (``factory.build_model`` and ``init_weights`` are never called)
    and the host model's ViT is on the meta device."""
    import multihmr_tpu_torch.factory as factory
    from multihmr_tpu_torch.cli import serve

    def refuse(*a, **kw):
        raise AssertionError("a second net was built")

    hosts = []
    monkeypatch.setattr(factory, "build_model", refuse)
    monkeypatch.setattr(MultiHMRNet, "init_weights", refuse)
    monkeypatch.setattr(factory, "build_host_model",
                        lambda name, f=factory.build_host_model: hosts.append(f(name)) or hosts[0])
    srv, batcher = serve.build_server(serve.parse_args(["--artifact", artifact, "--device",
                                                        "cpu", "--port", "0"]))
    srv.server_close()
    batcher.close()
    assert all(p.is_meta for p in hosts[0].net.backbone.parameters())
