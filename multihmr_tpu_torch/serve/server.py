"""Batching HTTP inference server (``multihmr_tpu/serve/server.py``).

Stdlib-only (ThreadingHTTPServer); each request handler thread blocks on
its own future while the :class:`~multihmr_tpu_torch.serve.batcher.DynamicBatcher`
worker coalesces concurrent requests into full fixed-shape batches on the
card.

Endpoints:
  POST /infer          image bytes → JSON persons (scores, loc, transl,
                       transl_pelvis, j2d-count); ``?render=1`` → PNG overlay
  GET  /healthz        liveness
  GET  /stats          batcher stats (batch-size histogram, p50/p95 latency)

One batch on the card: the uint8 wire batch goes from a pinned host buffer
to the card (``non_blocking``), is normalized there in fp32 as
``normalize_nhwc`` does on the host, runs the model's fused batch forward,
and the fields the server returns are copied back into pinned buffers, all
``max_people`` slots (no sync to count the valid ones), followed by one CUDA
event. ``batch_fn`` returns then; ``extract_fn`` waits on that event only
and builds the persons from host memory, as ``extract_persons(out, fields)``
does. With ``forward_fn=`` an exported artifact's forward runs in place
of the model's, on the same wire and readback (the JAX server switches to
an fp32 wire for an artifact; this one keeps its one uint8 wire). The JAX
server runs a single chip's batch image by image (``batch_mode="auto"`` →
``lax.map``); this one runs the fused batch, and a request's result equals
the same image alone in slot 0 of the same batch.

Data-parallel serving (``mesh=``, a list of devices, ``cli/serve.py --dp``):
the form of parallel/infer.py, one replica of the weights per device, each
batch cut into equal chunks in order, each chunk's forward and readback on
its own device, the persons put back together in order on the host.
"""

from __future__ import annotations

import functools
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

# the fields of the JSON answer: a json_only server reads back only these
JSON_FIELDS = ["scores", "loc", "transl", "transl_pelvis", "j2d"]


def build_batched_infer(model, max_batch: int = 8,
                        det_thresh: float = 0.3, nms_kernel_size: int = 3,
                        max_delay_ms: float = 5.0, forward_fn=None,
                        fields=None, mesh=None, max_queue: int = 0, deadline_s: float = 0.0):
    """(batcher, preprocess) for ``model`` (a ``MultiHMR`` on its device,
    weights included) at a fixed batch capacity.

    ``fields``: restrict the device→host readback per batch (see
    ``MultiHMR.extract_persons``). Requests submit the resized uint8
    pixels, normalized on the card. ``forward_fn``: an exported artifact,
    ``io.export.as_model_forward(load_exported(...))``, run on its
    ``device`` in place of ``model.forward`` (its detection parameters are
    the artifact's); ``model`` then only reads back the persons, and its net
    may hold no weights (``factory.build_host_model``). ``mesh``: a list of
    devices to serve data-parallel over (``max_batch`` a multiple of its
    length; not with ``forward_fn``)."""
    from multihmr_tpu_torch.io.preprocessing import preprocess_array
    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD
    from multihmr_tpu_torch.parallel.infer import DataParallel, persons_in_order
    from multihmr_tpu_torch.serve.batcher import DynamicBatcher

    norm = {}  # device → (mean, std)

    def upload(a: np.ndarray, device) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t

    def prepare(x, K, device):  # the u8 wire, normalized on the device
        if device not in norm:
            norm[device] = tuple(torch.from_numpy(a).to(device)
                                 for a in (IMG_NORM_MEAN, IMG_NORM_STD))
        mean, std = norm[device]
        return (upload(x, device).float() / 255.0 - mean) / std, upload(K, device)

    if mesh is not None:
        if forward_fn is not None:
            raise ValueError("mesh= (data-parallel serving) and forward_fn= (an exported "
                             "artifact) exclude each other")
        try:
            devices = [torch.device(d) for d in mesh]
        except (TypeError, RuntimeError) as e:
            raise ValueError(f"mesh= takes a list of devices, got {mesh!r}") from e
        dp = DataParallel(model, devices)
        if max_batch % len(dp):
            raise ValueError(f"max_batch {max_batch} must divide over the {len(dp)} devices")

        def batch_fn(x, K):
            with torch.inference_mode():
                return dp.start_persons(x, K, fields, prepare, det_thresh=det_thresh,
                                        nms_kernel_size=nms_kernel_size)

        def extract_fn(pending, n_valid):
            return persons_in_order(pending)[:n_valid]
    else:
        if forward_fn is None:
            device = model.body_model.v_template.device
            forward_fn = functools.partial(model.forward, det_thresh=det_thresh,
                                           nms_kernel_size=nms_kernel_size)
        else:
            device = torch.device(forward_fn.device)

        def batch_fn(x, K):
            # the worker thread's own grad mode: it does not inherit the caller's
            with torch.inference_mode():
                return model.start_persons(forward_fn(*prepare(x, K, device)), fields)

        def extract_fn(pending, n_valid):
            return pending.persons()[:n_valid]  # waits on the batch's event only

    S = model.cfg.img_size

    def preprocess(img_rgb: np.ndarray, fov: float = 60.0):
        p = preprocess_array(img_rgb, S, fov=fov)  # raw resized pixels: the card normalizes
        return np.asarray(p.resized, np.uint8), p.K, p.original

    batcher = DynamicBatcher(
        batch_fn, extract_fn, max_batch=max_batch, max_delay_ms=max_delay_ms,
        wire_dtype=np.uint8, max_queue=max_queue, deadline_s=deadline_s,
    )
    return batcher, preprocess


def _persons_json(persons) -> bytes:
    out = []
    for h in persons:
        out.append({
            "score": float(np.asarray(h["scores"])),
            "loc": np.asarray(h["loc"]).tolist(),
            "transl": np.asarray(h["transl"]).tolist(),
            "transl_pelvis": np.asarray(h["transl_pelvis"]).reshape(-1).tolist(),
            "n_j2d": int(np.asarray(h["j2d"]).shape[0]),
        })
    return json.dumps({"persons": out, "count": len(out)}).encode()


def make_server(model, port: int = 8000, max_batch: int = 8,
                det_thresh: float = 0.3, nms_kernel_size: int = 3,
                max_delay_ms: float = 5.0, forward_fn=None,
                json_only: bool = False, mesh=None, warmup: bool = True,
                max_queue: int = 0, deadline_s: float = 0.0):
    """Build (ThreadingHTTPServer, batcher). Caller runs serve_forever().
    ``forward_fn``/``mesh``: see :func:`build_batched_infer`. ``json_only``:
    skip the mesh-tensor (v3d/rotvec/shape/...) readback — /infer?render=1
    then returns 400. ``warmup``: run one dummy batch on the batcher's
    worker thread before the socket listens (the kernels' first-use build
    included), and build the rasterizer unless ``json_only``; a failed
    build raises here. ``max_queue``/``deadline_s``: overload policy — a
    full queue sheds with HTTP 429 + Retry-After, a request that ages past
    the deadline before dispatch fails with 503 (see
    :class:`DynamicBatcher`)."""
    from PIL import Image

    from multihmr_tpu_torch.io import native
    from multihmr_tpu_torch.io.preprocessing import rescale_K_to_original
    from multihmr_tpu_torch.render import overlay_human_meshes
    from multihmr_tpu_torch.serve.batcher import DeadlineExceeded, QueueFull

    batcher, preprocess = build_batched_infer(
        model, max_batch=max_batch, det_thresh=det_thresh,
        nms_kernel_size=nms_kernel_size, max_delay_ms=max_delay_ms,
        forward_fn=forward_fn, fields=JSON_FIELDS if json_only else None,
        mesh=mesh, max_queue=max_queue, deadline_s=deadline_s,
    )
    try:
        if warmup:
            batcher.warmup((model.cfg.img_size, model.cfg.img_size, 3),
                           dtype=batcher.wire_dtype)
        if not json_only:
            native.build()
    except BaseException:
        batcher.close()
        raise
    faces = model.body_model.faces.cpu().numpy()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "application/json", b'{"status":"ok"}')
            elif self.path == "/stats":
                self._send(
                    200, "application/json",
                    json.dumps(batcher.stats.snapshot()).encode(),
                )
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            if parsed.path != "/infer":
                self._send(404, "text/plain", b"not found")
                return
            render = parse_qs(parsed.query).get("render", ["0"])[0] == "1"
            if render and json_only:
                # reject BEFORE decoding/preprocessing the image body
                self._send(400, "application/json",
                           b'{"error":"server started json_only"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = np.asarray(
                    Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB")
                )
                x, K, pil = preprocess(img)
                persons = batcher.submit(x, K)
                if render:
                    S = model.cfg.img_size
                    K_full = rescale_K_to_original(
                        K[None], pil.size[0], pil.size[1], S
                    )
                    overlay, _ = overlay_human_meshes(
                        persons, faces, K_full, pil
                    )
                    buf = io.BytesIO()
                    Image.fromarray(overlay).save(buf, format="PNG")
                    self._send(
                        200, "image/png", buf.getvalue(),
                        extra=[("X-Person-Count", str(len(persons)))],
                    )
                else:
                    self._send(200, "application/json", _persons_json(persons))
            except BrokenPipeError:  # pragma: no cover
                pass
            except QueueFull as e:
                # load shed: tell the client when to come back instead of
                # queueing past the serving ceiling
                self._send(
                    429, "application/json",
                    json.dumps({"error": "overloaded",
                                "retry_after_s": round(e.retry_after_s, 1)}
                               ).encode(),
                    extra=[("Retry-After",
                            str(max(1, int(round(e.retry_after_s)))))],
                )
            except DeadlineExceeded as e:
                self._send(
                    503, "application/json",
                    json.dumps({"error": f"deadline exceeded: {e}"}).encode(),
                )
            except TimeoutError as e:
                self._send(
                    504, "application/json",
                    json.dumps({"error": f"timeout: {e}"}).encode(),
                )
            except Exception as e:
                self._send(
                    500, "application/json",
                    json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(),
                )

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of concurrent
        # clients beyond that gets TCP connection resets. The batcher queue
        # is the real limiter.
        request_queue_size = 128
        daemon_threads = True

    try:
        srv = Server(("0.0.0.0", port), Handler)
    except BaseException:
        batcher.close()
        raise
    srv.batcher = batcher  # for tests / shutdown
    return srv, batcher


def serve_forever_in_thread(srv) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return t
