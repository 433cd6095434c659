"""The port's interactive app (``multihmr_tpu_torch/cli/app.py``) on the
CPU: the cases of tests/test_app_server.py (the stdlib HTTP round trip, the
result cache), on the tiny model of tests/test_torch_serve.py, whose
weights the JAX app also gets: both store the ViT in bf16 and find the same
persons."""

import io
import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from tests.test_torch_serve import pair  # noqa: F401  (module fixture)
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


@pytest.fixture
def infer_pair(pair):  # noqa: F811
    """(port infer, JAX infer), each on a fresh copy of the same weights."""
    import copy

    from multihmr_tpu.cli.app import build_infer as jbuild_infer
    from multihmr_tpu_torch.cli.app import build_infer

    cfg, params, jm, tm = pair
    infer, model = build_infer("tiny", None, model=copy.deepcopy(tm))
    jinfer, _ = jbuild_infer("tiny", None, model=jm, params=params)
    return infer, jinfer


def test_stdlib_server_roundtrip(infer_pair):
    from PIL import Image

    infer, jinfer = infer_pair
    img = np.random.default_rng(0).integers(0, 255, size=(80, 100, 3), dtype=np.uint8)
    overlay, glb, count = infer(img)
    assert overlay.shape == img.shape and isinstance(glb, bytes) and glb[:4] == b"glTF"
    j_overlay, j_glb, j_count = jinfer(img)
    assert count == j_count
    assert j_overlay.shape == overlay.shape

    # serve over HTTP: a one-shot server on an ephemeral port
    holder = {}

    def run():
        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b'{"status": "ok"}')

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                arr = np.asarray(Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB"))
                overlay, glb, count = infer(arr)
                buf = io.BytesIO()
                Image.fromarray(overlay).save(buf, format="PNG")
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Person-Count", str(count))
                self.end_headers()
                self.wfile.write(buf.getvalue())

        srv = HTTPServer(("127.0.0.1", 0), H)
        holder["srv"] = srv
        srv.serve_forever()

    threading.Thread(target=run, daemon=True).start()
    for _ in range(100):
        if "srv" in holder:
            break
        time.sleep(0.05)
    port = holder["srv"].server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert b"ok" in r.read()
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "image/png"
            assert int(r.headers["X-Person-Count"]) == count
            out = np.asarray(Image.open(io.BytesIO(r.read())))
            np.testing.assert_array_equal(out, overlay)
    finally:
        holder["srv"].shutdown()


def test_result_cache_roundtrip(pair, tmp_path):  # noqa: F811
    """A repeated call with identical inputs is served from the on-disk
    cache (reference app.py:97-103); other parameters compute afresh."""
    import copy

    from multihmr_tpu_torch.cli.app import build_infer

    cache = tmp_path / "cache"
    infer, _ = build_infer("tiny", None, model=copy.deepcopy(pair[3]), cache_dir=str(cache))
    img = np.random.default_rng(1).integers(0, 255, size=(64, 64, 3), dtype=np.uint8)
    overlay1, glb1, count1 = infer(img, det_thresh=0.3)
    files = sorted(os.listdir(cache))
    assert any(f.endswith(".png") for f in files) and any(f.endswith(".glb") for f in files)
    # prove the second call reads the cache: poison the cached glb
    glb_fn = next(f for f in files if f.endswith(".glb"))
    with open(cache / glb_fn, "wb") as f:
        f.write(b"POISONED")
    overlay2, glb2, count2 = infer(img, det_thresh=0.3)
    assert glb2 == b"POISONED" and count2 == count1
    np.testing.assert_array_equal(overlay2, overlay1)
    # different params -> different cache entry -> fresh compute
    _, glb3, _ = infer(img, det_thresh=0.5)
    assert glb3 != b"POISONED"


def test_cache_keyed_by_weights(pair, tmp_path):  # noqa: F811
    """An entry written with other weights is not served: the key holds a
    digest of the weights, so the same weights built again hit the cache
    and changed weights compute afresh."""
    import copy

    import torch

    from multihmr_tpu_torch.cli.app import build_infer

    cache = tmp_path / "cache"
    img = np.random.default_rng(3).integers(0, 255, size=(64, 64, 3), dtype=np.uint8)
    infer, _ = build_infer("tiny", None, model=copy.deepcopy(pair[3]), cache_dir=str(cache))
    infer(img)
    glb_fn = next(f for f in os.listdir(cache) if f.endswith(".glb"))
    with open(cache / glb_fn, "wb") as f:
        f.write(b"POISONED")
    same, _ = build_infer("tiny", None, model=copy.deepcopy(pair[3]), cache_dir=str(cache))
    assert same(img)[1] == b"POISONED"
    other = copy.deepcopy(pair[3])
    with torch.no_grad():
        next(other.net.parameters()).add_(1.0)
    infer_other, _ = build_infer("tiny", None, model=other, cache_dir=str(cache))
    assert infer_other(img)[1][:4] == b"glTF"
    assert len([f for f in os.listdir(cache) if f.endswith(".glb")]) == 2


def test_cache_prunes_to_its_size(pair, tmp_path):  # noqa: F811
    import copy

    from multihmr_tpu_torch.cli.app import build_infer

    cache = tmp_path / "cache"
    infer, _ = build_infer("tiny", None, model=copy.deepcopy(pair[3]), cache_dir=str(cache),
                           cache_max_entries=2)
    rng = np.random.default_rng(2)
    for _ in range(4):
        infer(rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8))
    assert len(os.listdir(cache)) == 4  # 2 entries of a .png and a .glb


def test_app_without_a_card_raises(monkeypatch):
    import torch

    from multihmr_tpu_torch.cli.app import build_infer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_infer("multiHMR_672_S", None)
