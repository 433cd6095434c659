"""Interactive web demo (``multihmr_tpu/cli/app.py``), the analogue of
reference app.py (Gradio HF-space).

Serves single-image inference with overlay + downloadable .glb. Uses gradio
when installed; otherwise a dependency-free stdlib HTTP server (POST an
image, get the overlay PNG back). The gradio branch is the JAX package's,
copied as it is; gradio is not installed where the port is tested, so that
branch is untested.

Usage:
    python -m multihmr_tpu_torch.cli.app --model_name multiHMR_672_S [--ckpt ...] \
        [--port 7860] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import tempfile

import numpy as np
import torch


def build_infer(model_name: str, ckpt, model=None, cache_dir=None,
                cache_max_entries: int = 50, device="cuda"):
    """(infer, model): ``infer(img, det_thresh, nms_kernel_size, fov)`` →
    (overlay uint8, glb bytes, n_persons) for a ``model`` (built from
    ``model_name`` and ``ckpt`` on ``device`` when not given), whose ViT
    weights are stored in bf16 here as for any inference. The result cache
    in ``cache_dir`` is keyed by the image, the parameters and a digest of
    the weights and body model, so no entry made with other weights is
    served."""
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.preprocessing import rescale_K_to_original
    from multihmr_tpu_torch.render import overlay_human_meshes, create_glb_scene
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    if model is None:
        if str(device).startswith("cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError("device cuda but torch sees no CUDA card; pass "
                                   "device='cpu' to run on the CPU")
            # fp32 geometry as the JAX package's precision=HIGHEST: no TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = build_model(model_name, device=device, seed=0, checkpoint=ckpt)
    cast_backbone_bf16(model.net)  # inference: bf16 weight storage
    faces = model.body_model.faces.cpu().numpy()
    dev = model.body_model.v_template.device
    weights = _weights_digest(model) if cache_dir is not None else None

    def _cache_paths(img, det_thresh, nms_kernel_size, fov):
        """Per-example result cache (reference app.py:83-103 keys results by
        example basename + params; we key by image content hash so repeated
        uploads of the same image hit too, and by the weights' digest;
        pruned to ``cache_max_entries``)."""
        h = hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()[:16]
        base = (
            f"{h}_{model_name}_{weights}_thresh{int(det_thresh * 100)}"
            f"_nms{int(nms_kernel_size)}_fov{int(fov)}"
        )
        return (
            os.path.join(cache_dir, base + ".png"),
            os.path.join(cache_dir, base + ".glb"),
        )

    def _prune_cache():
        entries = sorted(
            (os.path.join(cache_dir, f) for f in os.listdir(cache_dir)),
            key=os.path.getmtime,
        )
        for old in entries[: max(0, len(entries) - 2 * cache_max_entries)]:
            try:
                os.remove(old)
            except OSError:
                pass

    def infer(img: np.ndarray, det_thresh: float = 0.3, nms_kernel_size: int = 3,
              fov: float = 60):
        """img: HWC uint8. Returns (overlay uint8, glb bytes, n_persons)."""
        from PIL import Image

        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            png_fn, glb_fn = _cache_paths(img, det_thresh, nms_kernel_size, fov)
            if os.path.exists(png_fn) and os.path.exists(glb_fn):
                cached = Image.open(png_fn)
                count = int(cached.info.get("n_persons", -1))
                with open(glb_fn, "rb") as f:
                    return np.asarray(cached.convert("RGB")), f.read(), count

        from multihmr_tpu_torch.io.preprocessing import preprocess_array

        S = model.cfg.img_size
        pre = preprocess_array(img, S, fov=fov)
        pil, resized = pre.original, pre.resized
        K = pre.K[None]
        with torch.inference_mode():
            out = model.forward(torch.from_numpy(pre.x[None]).to(dev),
                                torch.from_numpy(K).to(dev), det_thresh=det_thresh,
                                nms_kernel_size=nms_kernel_size)
        humans = model.extract_persons(out)[0]
        K_full = rescale_K_to_original(K, pil.size[0], pil.size[1], S)
        overlay, _ = overlay_human_meshes(humans, faces, K_full, pil)
        glb = create_glb_scene(
            [np.asarray(h["v3d"]) for h in humans], [faces] * len(humans),
            img=resized, focal=float(K[0, 0, 0]),
        )
        if cache_dir is not None:
            from PIL.PngImagePlugin import PngInfo

            meta = PngInfo()
            meta.add_text("n_persons", str(len(humans)))
            Image.fromarray(overlay).save(png_fn, pnginfo=meta)
            with open(glb_fn, "wb") as f:
                f.write(glb)
            _prune_cache()
        return overlay, glb, len(humans)

    return infer, model


def _weights_digest(model) -> str:
    """sha1 of the network's weights and the body model's arrays, 16 hex digits."""
    def arrays(obj, prefix=""):
        for k, v in sorted(vars(obj).items()):
            if torch.is_tensor(v):
                yield prefix + k, v
            elif hasattr(v, "__dataclass_fields__"):  # the Anny model's SMPL-like base
                yield from arrays(v, prefix + k + ".")

    h = hashlib.sha1()
    for name, t in [*model.net.state_dict().items(), *arrays(model.body_model)]:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def serve_stdlib(infer, port: int):
    """Minimal fallback server: POST image bytes to /infer → PNG overlay;
    GET /health → JSON."""
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/health":
                body = json.dumps({"status": "ok"}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path.startswith("/infer"):
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                overlay, glb, count = infer(img)
                buf = io.BytesIO()
                Image.fromarray(overlay).save(buf, format="PNG")
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Person-Count", str(count))
                self.end_headers()
                self.wfile.write(buf.getvalue())
            else:
                self.send_response(404)
                self.end_headers()

    print(f"serving on http://0.0.0.0:{port} (POST /infer, GET /health)")
    HTTPServer(("0.0.0.0", port), Handler).serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str, default="multiHMR_672_S")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument(
        "--cache_dir",
        type=str,
        default=os.path.join(tempfile.gettempdir(), "multihmr_tpu_torch_results"),
        help="per-example result cache (reference app.py:97-103); '' disables",
    )
    args = p.parse_args(argv)

    infer, model = build_infer(
        args.model_name, args.ckpt, cache_dir=args.cache_dir or None, device=args.device
    )
    try:
        import gradio as gr
    except ImportError:
        serve_stdlib(infer, args.port)
        return

    def gr_infer(img, det_thresh, nms, fov):
        overlay, glb, count = infer(img, det_thresh, int(nms), fov)
        glb_path = os.path.join(tempfile.mkdtemp(), "scene.glb")
        with open(glb_path, "wb") as f:
            f.write(glb)
        return overlay, glb_path, f"{count} persons"

    demo = gr.Interface(
        fn=gr_infer,
        inputs=[
            gr.Image(type="numpy"),
            gr.Slider(0.05, 0.9, value=0.3, label="detection threshold"),
            gr.Slider(1, 7, value=3, step=2, label="NMS kernel"),
            gr.Slider(30, 110, value=60, label="FOV"),
        ],
        outputs=[gr.Image(), gr.Model3D(), gr.Text()],
        title=f"Multi-HMR — {args.model_name}",
    )
    demo.launch(server_port=args.port)


if __name__ == "__main__":
    main()
