"""Batch-inference CLI (``multihmr_tpu/cli/demo.py``), the analogue of
reference demo.py:244-384.

Usage:
    python -m multihmr_tpu_torch.cli.demo --img_folder imgs --out_folder out \
        --model_name multiHMR_896_L [--ckpt multiHMR_896_L.pt] [--device cuda] \
        [--det_thresh 0.3] [--nms_kernel_size 3] [--fov 60] [--save_mesh 1] \
        [--extra_views 1] [--distance 1] [--unique_color 1] \
        [--save_rotating_video 1] [--alpha 0.75]

For each image it writes what the JAX demo writes: ``<name>_<model>.png``
(the image beside its mesh overlay, ``--distance`` printing each person's
distance, ``--extra_views`` adding a 45-degree side view), a rotating
video with ``--save_rotating_video`` (named as the JAX demo names it: that
PNG's path with every ".png" replaced by "_rotating.mp4"; PNG frames
without imageio or cv2), and with ``--save_mesh`` the ``.glb`` scene and a
``.obj`` per person and the persons' vertices ``[P, V, 3]``
(``<name>_<model>.png.glb``, ``.png.person<j>.obj``, ``.png.npy``).
Besides, ``<name>_<model>.json`` (the detected persons).
``--ckpt`` converts a reference ``multiHMR_*.pt`` on the fly; without it the
weights are seeded random ones (for pipeline checks only).

The loop is the JAX demo's one-stage pipeline: image *i+1*'s forward is
enqueued on the card before image *i*'s host work (readback, rendering,
files). :func:`start_image` enqueues one image's forward and then the
copies of its persons into pinned host memory, with one CUDA event after
them; :func:`finish_image` waits on that event alone (not on the stream,
where image *i+1*'s forward now runs) and writes the files.
:func:`run_image` is both for one image; they take a decoded uint8 array
(or, with ``x=``, the image already preprocessed), so other drivers run
exactly the demo's path.

As in the JAX demo, the images are decoded, resized and normalized by the
native prefetching loader (``io/native.py::NativeImageLoader``, a worker
pool in C++) when its library builds here, else on the main thread with
PIL; the summary line names the one that ran (``"loader"``), and a failed
build is printed to stderr. The port takes the loader's tensors in the
folder's sorted order, holding those that arrive early, where the JAX demo
collects the whole folder first. An image the loader cannot decode goes
through PIL, as in the JAX demo. The overlay opens the original image.

An Anny-family name (``multiHMR_672_L_anny``) runs ``MultiHMRAnny`` with the
demo's FOV-``--fov`` K, so its persons' ``K`` is that K (``K_regressed`` and
``fov`` are the network's own). ``multiHMR_896_G`` runs the port's own
ViT-g/14 configuration (``port_config.py``), for which no released
checkpoint exists: seeded weights, or a ``--ckpt`` in the hub's naming.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import numpy as np
import torch

from multihmr_tpu_torch.io.preprocessing import get_camera_parameters, preprocess_array


@torch.inference_mode()
def predict(model, img_rgb: np.ndarray, fov: float = 60.0, det_thresh: float = 0.3,
            nms_kernel_size: int = 3, x: np.ndarray = None) -> dict:
    """One decoded uint8 HWC RGB image → the model's ``[1, K]`` outputs on
    the model's device. ``x``: the image already preprocessed instead
    (``[S, S, 3]`` float32, contained, padded and normalized, as
    ``io/native.py::preprocess_file`` gives it); ``img_rgb`` is then unused."""
    S = model.cfg.img_size
    if x is None:
        x = preprocess_array(img_rgb, S, fov=fov).x
    elif x.shape != (S, S, 3) or x.dtype != np.float32:
        raise ValueError(f"x must be float32 [{S}, {S}, 3], got {x.dtype} {list(x.shape)}")
    device = model.body_model.v_template.device
    K = get_camera_parameters(S, fov=fov)  # preprocess_array's K
    return model.forward(torch.from_numpy(x)[None].to(device), torch.from_numpy(K).to(device),
                         det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)


def persons_to_json(persons: list) -> list:
    """Person dicts of numpy arrays → JSON-ready lists (meshes left out)."""
    return [{k: np.asarray(v).tolist() for k, v in p.items() if k != "v3d"}
            for p in persons]


def start_image(model, img_rgb: np.ndarray, fov: float = 60.0, det_thresh: float = 0.3,
                nms_kernel_size: int = 3, x: np.ndarray = None):
    """Enqueue one image's forward (of ``img_rgb``, or of the preprocessed
    ``x``, as :func:`predict`) and its persons' device→host copies; returns
    (outputs, pending persons) without waiting for the card."""
    out = predict(model, img_rgb, fov=fov, det_thresh=det_thresh,
                  nms_kernel_size=nms_kernel_size, x=x)
    return out, model.start_persons(out)


def finish_image(model, pending, img_rgb: np.ndarray, name: str, out_folder: str, tag: str,
                 fov: float = 60.0, save_mesh: bool = False, overlay=None) -> list:
    """Wait for one image's persons and write its files; returns the persons.
    ``overlay``: None writes the JSON (and with ``save_mesh`` the ``.npy``)
    alone; else the demo's flags (``extra_views``, ``distance``,
    ``unique_color``, ``save_rotating_video``, ``alpha``), and the JAX demo's
    overlay PNG, views, video, ``.glb`` and ``.obj`` files too."""
    persons = pending.persons()[0]
    stem = os.path.join(out_folder, f"{name}_{tag}")
    with open(stem + ".json", "w") as f:
        json.dump({"image": name, "persons": persons_to_json(persons)}, f)
    if save_mesh:
        V = model.body_model.num_vertices
        meshes = np.stack([p["v3d"] for p in persons]) if persons else np.zeros((0, V, 3))
        np.save(stem + ".png.npy", meshes.astype(np.float32))  # the JAX demo's name
    if overlay is not None:
        _write_overlays(model, persons, img_rgb, stem + ".png", fov, save_mesh, overlay)
    return persons


def _write_overlays(model, persons, img_rgb, save_fn, fov, save_mesh, opts):
    """The JAX demo's per-image files (multihmr_tpu/cli/demo.py:143-183)."""
    from PIL import Image

    from multihmr_tpu_torch import render
    from multihmr_tpu_torch.io.preprocessing import get_camera_parameters, rescale_K_to_original

    faces = model.body_model.faces.cpu().numpy()
    h, w = img_rgb.shape[:2]
    K_full = rescale_K_to_original(get_camera_parameters(model.cfg.img_size, fov=fov), w, h,
                                   model.cfg.img_size)
    arr, colors = render.overlay_human_meshes(
        persons, faces, K_full, img_rgb, unique_color=bool(opts.unique_color), alpha=opts.alpha)
    if opts.distance:
        arr = render.print_distance_on_image(arr, persons, colors)
    panels = [np.asarray(img_rgb), arr]
    l_mesh = [np.asarray(p["v3d"]) for p in persons]
    if opts.extra_views and persons:
        panels.append(render.render_view_from_angle(
            l_mesh, [faces] * len(l_mesh), K_full[0], arr.shape[1], arr.shape[0], angle_deg=45))
    Image.fromarray(np.concatenate(panels, 1).astype(np.uint8)).save(save_fn)
    if opts.save_rotating_video and persons:
        render.create_rotating_video(
            l_mesh, [faces] * len(l_mesh), K_full[0], arr.shape[1], arr.shape[0],
            fn=save_fn.replace(".png", "_rotating.mp4"), n_frames=20)
    if save_mesh:
        render.create_glb_scene(l_mesh, [faces] * len(l_mesh), save_fn + ".glb")
        for j, m in enumerate(l_mesh):
            render.export_obj(save_fn + f".person{j}.obj", m, faces)


def run_image(model, img_rgb: np.ndarray, name: str, out_folder: str, tag: str,
              fov: float = 60.0, det_thresh: float = 0.3, nms_kernel_size: int = 3,
              save_mesh: bool = False, overlay=None):
    """Predict one image and write its outputs; returns (outputs, persons)."""
    out, pending = start_image(model, img_rgb, fov=fov, det_thresh=det_thresh,
                               nms_kernel_size=nms_kernel_size)
    persons = finish_image(model, pending, img_rgb, name, out_folder, tag, fov=fov,
                           save_mesh=save_mesh, overlay=overlay)
    return out, persons


def _native_loader(paths: list, img_size: int):
    """The prefetching loader over ``paths``, or None (with the reason on
    stderr) where the image library does not build or load."""
    from multihmr_tpu_torch.io import native

    try:
        return native.NativeImageLoader(paths, img_size)
    except (RuntimeError, OSError) as err:
        print(f"demo: decoding with PIL, the native image loader is unavailable: {err}",
              file=sys.stderr)
        return None


def in_order(loader):
    """The loader's tensors in index order: ``[S, S, 3]`` float32, or None
    for an image it could not decode. Tensors that arrive before their turn
    wait in a dict: those finished while an earlier image still decodes."""
    held, it = {}, iter(loader)
    for i in range(len(loader)):
        while i not in held:
            idx, x = next(it)
            held[idx if idx >= 0 else -idx - 1] = x if idx >= 0 else None
        yield held.pop(i)


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
    paths = [os.path.join(args.img_folder, n) for n in names]
    loader = _native_loader(paths, model.cfg.img_size)
    prepared = in_order(loader) if loader is not None else iter([None] * len(names))
    open_rgb = lambda i: np.asarray(Image.open(paths[i]).convert("RGB"))  # noqa: E731
    # one stage in flight: image i+1's forward is enqueued before image i's
    # host work. `waits` is the residual stall on image i's event (card time
    # the host work did not hide); `periods` the wall between consecutive
    # images' ends, the pipeline's time per image
    waits, periods = [], []
    wall_t0 = t_prev = time.perf_counter()
    pending = None  # (index, image or None, pending persons)
    try:
        for i in range(len(names) + 1):
            nxt = None
            if i < len(names):
                x = next(prepared)
                # None: no loader, or the loader could not decode it (PIL then)
                img = open_rgb(i) if x is None else None
                _, persons_next = start_image(model, img, fov=args.fov,
                                              det_thresh=args.det_thresh,
                                              nms_kernel_size=args.nms_kernel_size, x=x)
                nxt = (i, img, persons_next)
            if pending is not None:
                done_i, done_img, done_persons = pending
                t0 = time.perf_counter()
                done_persons.wait()
                waits.append(time.perf_counter() - t0)
                if done_img is None:  # the overlay draws on the original image
                    done_img = open_rgb(done_i)
                persons = finish_image(model, done_persons, done_img, names[done_i],
                                       args.out_folder, args.model_name, fov=args.fov,
                                       save_mesh=bool(args.save_mesh), overlay=args)
                t_now = time.perf_counter()
                periods.append(t_now - t_prev)
                t_prev = t_now
                print(f"{names[done_i]}: {len(persons)} persons, {1000 * periods[-1]:.1f} ms, "
                      f"{1000 * waits[-1]:.1f} ms wait")
            pending = nxt
    finally:
        if loader is not None:
            loader.close()
    wall_s = time.perf_counter() - wall_t0
    print(json.dumps({
        "n_images": len(names),
        "device": str(model.body_model.v_template.device),
        "loader": "pil" if loader is None else "native",
        "p50_image_ms": float(1000 * np.median(periods)) if periods else None,
        "p50_wait_ms": float(1000 * np.median(waits)) if waits else None,
        "wall_s": round(wall_s, 3),
        "img_per_s": round(len(names) / wall_s, 2) if names else None,
    }))

if __name__ == "__main__":
    main()
