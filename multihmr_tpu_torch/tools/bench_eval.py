"""Eval-sweep wall clock on a synthetic EHF-sized set (``tools/bench_eval.py`` of the JAX package).

    python -m multihmr_tpu_torch.tools.bench_eval [--model_name multiHMR_672_S] [--images 100]
        [--wire f32|u8] [--skip_serial] [--json_out PATH] [--device cuda]

Drives the real evaluation surface (``train/evaluate.py::evaluate_dataset``)
over a seeded fixture set with EHF-like ground truth (1-2 people per image,
the body model's template placed 2-4 m deep; meshes and joints precomputed
and handed over by the ``gt_forward`` hook, so GT costs only host numpy in
the timed loop). Random weights predict meaningless meshes, but the times
are the production code's: the forward, the detection slots, the readback
and the host's matching and metrics. ``det_thresh`` is calibrated on the
first image's scores so that the model finds EHF-like person counts.
``--wire u8`` hands the images over as raw uint8, normalized on the card
(a quarter of the upload bytes). The pipelined loop runs, then the serial
one (the A/B). Prints one JSON line with the JAX tool's keys; ``--json_out``
also writes it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from multihmr_tpu_torch.factory import build_model
from multihmr_tpu_torch.io.preprocessing import get_camera_parameters, normalize_nhwc
from multihmr_tpu_torch.train.evaluate import evaluate_dataset
from multihmr_tpu_torch.utils.precision import cast_backbone_bf16


def build_fixture_dataset(model, n_images: int, seed: int = 0, wire: str = "f32"):
    """EHF-shaped (image, annot) pairs, draw for draw the JAX tool's: noise
    images (standard normals, or uint8 for ``wire='u8'``), 1-2 person GT
    meshes (the body model's template + noise, 2-4 m deep) with precomputed
    j3d/j2d, and the fov-60 K at the model's resolution."""
    S = model.cfg.img_size
    rng = np.random.default_rng(seed)
    v_template = model.body_model.v_template.cpu().numpy().astype(np.float32)
    Jreg = model.body_model.J_regressor.cpu().numpy().astype(np.float32)
    K = get_camera_parameters(S, fov=60)[0]

    items = []
    for _ in range(n_images):
        if wire == "u8":
            x = rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
        else:
            x = rng.normal(0, 1, (S, S, 3)).astype(np.float32)
        P = int(rng.integers(1, 3))  # 1-2 people, like EHF
        humans = []
        for _ in range(P):
            offs = np.array(
                [rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3),
                 rng.uniform(2.0, 4.0)], np.float32)
            verts = v_template + offs + rng.normal(0, 0.002, v_template.shape
                                                   ).astype(np.float32)
            humans.append({"smplx_vertices": verts})
        verts_all = np.stack([h["smplx_vertices"] for h in humans])
        j3d = np.einsum("jv,pvc->pjc", Jreg, verts_all)
        proj = j3d @ K.T
        j2d = proj[..., :2] / proj[..., 2:3]
        gt = {"v3d": verts_all, "j3d": j3d, "j2d": j2d}
        items.append((x, {"K": K, "humans": humans, "gt": gt}))
    return items


def calibrate_det_thresh(model, item, target: int = 2) -> float:
    """``det_thresh`` for EHF-like person counts under random weights: the
    midpoint between the ``target``-th and the next score on the image."""
    x, annot = item
    if x.dtype == np.uint8:  # the pixels the evaluation's forward sees
        x = normalize_nhwc(x)
    device = model.body_model.v_template.device
    with torch.inference_mode():
        out = model.forward(torch.from_numpy(np.asarray(x[None], np.float32)).to(device),
                            torch.from_numpy(annot["K"][None]).to(device), det_thresh=0.0)
    scores = np.sort(out["scores_det"][0].float().cpu().numpy())[::-1]
    return float((scores[target - 1] + scores[target]) / 2.0)


def run(model, dataset, det_thresh: float, skip_serial: bool = False) -> dict:
    """The pipelined sweep after a one-image warm-up, then the serial A/B;
    returns the JAX tool's entry (without "model" and "wire")."""
    n_persons = [0]  # counted through a thin (untimed) wrapper
    orig_extract = model.extract_persons

    def counting_extract(out, fields=None):
        res = orig_extract(out, fields=fields)
        n_persons[0] += sum(len(pp) for pp in res)
        return res

    model.extract_persons = counting_extract
    gt_forward = lambda annot: annot["gt"]  # noqa: E731  (the fixtures' precomputed GT)
    try:
        evaluate_dataset(model, dataset[:1], det_thresh=det_thresh, gt_forward=gt_forward,
                         log_every=0)
        n_persons[0] = 0
        results = evaluate_dataset(model, dataset, det_thresh=det_thresh,
                                   gt_forward=gt_forward, log_every=0, pipeline=True)
        serial = None if skip_serial else evaluate_dataset(
            model, dataset, det_thresh=det_thresh, gt_forward=gt_forward, log_every=0,
            pipeline=False)
    finally:
        del model.extract_persons
    tm = results["timings"]
    wall = tm["wall"]
    attributed = sum(v for k, v in tm.items() if k != "wall")
    return {
        "images": len(dataset),
        "persons_detected": n_persons[0],
        "wall_s": round(wall, 2),
        "images_per_s": round(len(dataset) / wall, 1),
        "phases_s": {k: round(v, 2) for k, v in tm.items() if k != "wall"},
        "attributed_frac": round(attributed / wall, 3),
        "serial_wall_s": None if serial is None else round(serial["timings"]["wall"], 2),
        "pipeline_speedup": None if serial is None else round(serial["timings"]["wall"] / wall, 2),
        "f1": round(results["f1_score"], 3),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_name", default="multiHMR_672_S")
    p.add_argument("--images", type=int, default=100)
    p.add_argument("--wire", choices=("f32", "u8"), default="f32",
                   help="u8 = raw uint8 images, normalized on the card "
                        "(4x fewer upload bytes)")
    p.add_argument("--skip_serial", action="store_true",
                   help="skip the serial (reference-shaped) A/B phase")
    p.add_argument("--json_out", default=None, help="also write the entry here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = build_model(args.model_name, device=args.device, seed=0)
    cast_backbone_bf16(model.net)
    dataset = build_fixture_dataset(model, args.images, wire=args.wire)
    det_thresh = calibrate_det_thresh(model, dataset[0])
    print(f"# calibrated det_thresh={det_thresh:.4f}", file=sys.stderr)
    entry = {"model": args.model_name, "wire": args.wire,
             **run(model, dataset, det_thresh, args.skip_serial)}
    print(json.dumps(entry), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({f"eval_sweep_{args.model_name}": entry}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
