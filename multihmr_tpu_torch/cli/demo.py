"""Batch-inference CLI (``multihmr_tpu/cli/demo.py``).

Usage:
    python -m multihmr_tpu_torch.cli.demo --img_folder imgs --out_folder out \
        --model_name multiHMR_896_L [--ckpt multiHMR_896_L.pt] [--device cuda] \
        [--det_thresh 0.3] [--nms_kernel_size 3] [--fov 60] [--save_mesh 1]

For each image it writes ``<name>_<model>.json`` (the detected persons) and,
with ``--save_mesh``, ``<name>_<model>.npy`` (their vertices ``[P, V, 3]``).
``--ckpt`` converts a reference ``multiHMR_*.pt`` on the fly; without it the
weights are seeded random ones (for pipeline checks only). The overlay
rendering flags of the JAX demo are not ported yet and are refused.
:func:`run_image` is the per-image body; it takes a decoded uint8 array, so
other drivers run exactly the demo's path.

An Anny-family name (``multiHMR_672_L_anny``) runs ``MultiHMRAnny`` with the
demo's FOV-``--fov`` K, so its persons' ``K`` is that K (``K_regressed`` and
``fov`` are the network's own). This is a deliberate difference: the JAX
demo raises a ``TypeError`` for such a name, as it passes ``fields=`` to
``MultiHMRAnny.extract_persons``, which takes none; here it is called
without it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from multihmr_tpu_torch.io.preprocessing import preprocess_array

# the JAX demo's overlay flags, refused until the renderer is ported
_RENDER_FLAGS = ("extra_views", "distance", "unique_color", "save_rotating_video")


@torch.inference_mode()
def predict(model, img_rgb: np.ndarray, fov: float = 60.0, det_thresh: float = 0.3,
            nms_kernel_size: int = 3) -> dict:
    """One decoded uint8 HWC RGB image → the model's ``[1, K]`` outputs on
    the model's device."""
    pre = preprocess_array(img_rgb, model.cfg.img_size, fov=fov)
    device = model.body_model.v_template.device
    x = torch.from_numpy(pre.x)[None].to(device)
    K = torch.from_numpy(pre.K)[None].to(device)
    return model.forward(x, K, det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)


def persons_to_json(persons: list) -> list:
    """Person dicts of numpy arrays → JSON-ready lists (meshes left out)."""
    return [{k: np.asarray(v).tolist() for k, v in p.items() if k != "v3d"}
            for p in persons]


def run_image(model, img_rgb: np.ndarray, name: str, out_folder: str, tag: str,
              fov: float = 60.0, det_thresh: float = 0.3, nms_kernel_size: int = 3,
              save_mesh: bool = False):
    """Predict one image and write its outputs; returns (outputs, persons)."""
    out = predict(model, img_rgb, fov=fov, det_thresh=det_thresh,
                  nms_kernel_size=nms_kernel_size)
    persons = model.extract_persons(out)[0]
    stem = os.path.join(out_folder, f"{name}_{tag}")
    with open(stem + ".json", "w") as f:
        json.dump({"image": name, "persons": persons_to_json(persons)}, f)
    if save_mesh:
        V = model.body_model.num_vertices
        meshes = np.stack([p["v3d"] for p in persons]) if persons else np.zeros((0, V, 3))
        np.save(stem + ".npy", meshes.astype(np.float32))
    return out, persons


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_folder", type=str, required=True)
    parser.add_argument("--out_folder", type=str, default="demo_out")
    parser.add_argument("--model_name", type=str, default="multiHMR_896_L")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--det_thresh", type=float, default=0.3)
    parser.add_argument("--nms_kernel_size", type=int, default=3)
    parser.add_argument("--fov", type=float, default=60)
    parser.add_argument("--extra_views", type=int, default=0)
    parser.add_argument("--distance", type=int, default=0)
    parser.add_argument("--save_mesh", type=int, default=0)
    parser.add_argument("--unique_color", type=int, default=0)
    parser.add_argument("--save_rotating_video", type=int, default=0)
    parser.add_argument("--alpha", type=float, default=0.75)
    args = parser.parse_args(argv)
    for flag in _RENDER_FLAGS:
        if getattr(args, flag):
            parser.error(f"--{flag} needs the overlay renderer, which is not ported yet")

    from PIL import Image

    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    if args.device.startswith("cuda"):
        # fp32 geometry as the JAX package's precision=HIGHEST: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = build_model(args.model_name, device=args.device, seed=0, checkpoint=args.ckpt)
    if args.ckpt is None:
        print("WARNING: no checkpoint given — running with random weights")
    cast_backbone_bf16(model.net)  # inference: bf16 weight storage, after the load

    os.makedirs(args.out_folder, exist_ok=True)
    names = sorted(f for f in os.listdir(args.img_folder)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    durations = []
    wall_t0 = time.perf_counter()
    for name in names:
        img = np.asarray(Image.open(os.path.join(args.img_folder, name)).convert("RGB"))
        t0 = time.perf_counter()
        _, persons = run_image(
            model, img, name, args.out_folder, args.model_name, fov=args.fov,
            det_thresh=args.det_thresh, nms_kernel_size=args.nms_kernel_size,
            save_mesh=bool(args.save_mesh))
        durations.append(time.perf_counter() - t0)  # ends in a host readback
        print(f"{name}: {len(persons)} persons, {1000 * durations[-1]:.1f} ms")
    wall_s = time.perf_counter() - wall_t0
    print(json.dumps({
        "n_images": len(names),
        "device": str(model.body_model.v_template.device),
        "p50_image_ms": float(1000 * np.median(durations)) if durations else None,
        "wall_s": round(wall_s, 3),
    }))


if __name__ == "__main__":
    main()
