"""Numerical parity against the reference's outputs (``tools/parity_harness.py`` of the JAX package).

Runs a reference checkpoint (``multiHMR_*.pt``, converted by
``build_model(checkpoint=)``) over a folder of images and compares the
outputs with reference-side dumps, one ``<image>.npz`` per image (written by
the JAX package's ``tools/dump_reference_outputs.py`` on the reference's
side), stage by stage so that a conversion fault shows where it starts.

    # 0. validate the assets first (no checkpoint needed):
    python -m multihmr_tpu_torch.tools.parity_harness --check-assets /path/to/assets

    # 1. compare:
    python -m multihmr_tpu_torch.tools.parity_harness --ckpt multiHMR_896_L.pt \\
        --img_folder example_data --reference_dumps ref_dumps/ \\
        [--json_out parity_report.json] [--model_name multiHMR_896_L] [--fov 60] \\
        [--compute_dtype float32] [--device cuda]

Per-stage deltas (where the dumps carry ``stage_*`` keys): backbone patch
tokens → detection logits → HPH outputs (rotmat, betas, cam) → final
vertices, following the reference call stack (reference model.py:229,
:135, :281, :302). Exit code 0 iff the max PVE delta is under ``--tol_mm``
(0.5 mm, the BASELINE.md fidelity bar) and every image's person count
matches; 2 when no dump was compared. ``--compute_dtype`` overrides the
configuration's ViT dtype (bf16 by default; float32 to hold the
fp32 reference to fp32 arithmetic).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

# our stage keys, paired with the reference dump keys stage_<key>
STAGE_KEYS = ("backbone", "det_logits", "hph_rotmat", "hph_betas", "hph_cam")


def _delta_stats(ours: np.ndarray, ref: np.ndarray) -> dict:
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    # compare the ORIGINAL shapes before flattening: an equal-size layout
    # mismatch (e.g. a transposed dump) must surface as a shape error, not
    # as a gigantic-looking numerical delta
    if ours.shape != ref.shape:
        return {"error": "shape mismatch",
                "ours": list(ours.shape), "ref": list(ref.shape)}
    d = np.abs(ours.reshape(-1) - ref.reshape(-1))
    ref = ref.reshape(-1)
    return {
        "max_abs": float(d.max()) if d.size else 0.0,
        "mean_abs": float(d.mean()) if d.size else 0.0,
        "ref_scale": float(np.abs(ref).mean()) if ref.size else 0.0,
    }


def capture_stages(model, x, K, det_thresh, nms_kernel_size):
    """Forward with the stages captured by forward hooks on ``net.backbone``
    (its ``"patch_tokens"``) and ``net.mlp_classif``.

    Returns (out, stages): the whole forward's outputs, and the stages in
    the layouts of the reference hooks: backbone patch tokens [N, D],
    detection logits [N], and the HPH outputs of the VALID slots in
    detection order (the reference's ragged person order)."""
    net = model.net
    seen = {}
    hooks = [net.backbone.register_forward_hook(
                 lambda m, a, out: seen.__setitem__("backbone", out["patch_tokens"])),
             net.mlp_classif.register_forward_hook(
                 lambda m, a, out: seen.__setitem__("det_logits", out))]
    try:
        with torch.inference_mode():
            out = net(x, K, det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)
    finally:
        for h in hooks:
            h.remove()
    host = lambda t: t.float().cpu().numpy()  # noqa: E731
    valid = host(out["det"].valid)[0] > 0
    stages = {
        "backbone": host(seen["backbone"])[0],
        "det_logits": host(seen["det_logits"])[0, :, 0],
        "hph_rotmat": host(out["rotmat"])[0][valid],
        "hph_betas": host(out["shape"])[0][valid],
        "hph_cam": host(out["dist_postprocessed"])[0][valid][:, 0],
    }
    # the PVE comparison needs v3d/transl_pelvis: the body model on the
    # captured net outputs (no second backbone forward)
    with torch.inference_mode():
        return model.apply_body_model(out, K), stages


def run_check_assets(assets_dir: str) -> int:
    from multihmr_tpu_torch.bodymodel.manifest import check_assets_dir

    report = check_assets_dir(assets_dir)
    print(f"asset manifest for {assets_dir}:")
    for rel, n in sorted(report["found"].items()):
        print(f"  [{'OK  ' if n == 0 else 'FAIL'}] {rel}"
              + ("" if n == 0 else f" ({n} problem(s))"))
    for m in report["missing"]:
        print(f"  [miss] {m}")
    for w in report.get("warnings", []):
        print(f"  [warn] {w}")
    for p in report["problems"]:
        print(f"  !! {p}")
    required_missing = any("REQUIRED" in m for m in report["missing"])
    ok = not report["problems"] and not required_missing
    print("manifest:", "OK" if ok else "INVALID")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check-assets", dest="check_assets", default=None,
                   metavar="DIR", help="validate an assets tree and exit")
    p.add_argument("--ckpt")
    p.add_argument("--img_folder")
    p.add_argument("--reference_dumps")
    p.add_argument("--model_name", default="multiHMR_896_L")
    p.add_argument("--fov", type=float, default=60)
    p.add_argument("--det_thresh", type=float, default=0.3)
    p.add_argument("--nms_kernel_size", type=int, default=3)
    p.add_argument("--tol_mm", type=float, default=0.5)
    p.add_argument("--json_out", default=None,
                   help="write the per-image/per-stage delta table here")
    p.add_argument("--compute_dtype", default=None, choices=("float32", "bfloat16"),
                   help="the ViT's dtype (default: the configuration's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.check_assets is not None:
        return run_check_assets(args.check_assets)
    for req in ("ckpt", "img_folder", "reference_dumps"):
        if getattr(args, req) is None:
            p.error(f"--{req} is required (unless using --check-assets)")

    from multihmr_tpu_torch.config import named_config
    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.preprocessing import get_camera_parameters, open_image

    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = named_config(args.model_name)
    if args.compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    model = build_model(args.model_name, device=args.device, cfg=cfg, checkpoint=args.ckpt)
    K = torch.from_numpy(get_camera_parameters(model.cfg.img_size, fov=args.fov)).to(args.device)

    worst = 0.0
    n_imgs = 0
    count_mismatches = 0
    report = {"model": args.model_name, "tol_mm": args.tol_mm, "images": {}}
    for name in sorted(os.listdir(args.img_folder)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        dump_path = os.path.join(args.reference_dumps, os.path.splitext(name)[0] + ".npz")
        if not os.path.exists(dump_path):
            print(f"[skip] no reference dump for {name}")
            continue
        ref = np.load(dump_path)
        x, _ = open_image(os.path.join(args.img_folder, name), model.cfg.img_size)
        x = torch.from_numpy(x).to(args.device)
        want_stages = any(k.startswith("stage_") for k in ref.files)
        if want_stages:
            out, stages = capture_stages(model, x, K, args.det_thresh, args.nms_kernel_size)
        else:
            with torch.inference_mode():
                out = model.forward(x, K, det_thresh=args.det_thresh,
                                    nms_kernel_size=args.nms_kernel_size)
            stages = {}
        persons = model.extract_persons(out)[0]
        n_ref = len([k for k in ref.files if k.startswith("v3d_")])
        print(f"{name}: ours {len(persons)} persons, reference {n_ref}")
        n_imgs += 1
        entry = {"persons_ours": len(persons), "persons_ref": n_ref,
                 "stages": {}, "pve_mm": []}
        if len(persons) != n_ref:
            # a count mismatch IS a parity failure: else a model detecting
            # nobody would pass the PVE gate untested
            count_mismatches += 1
            print(f"  [FAIL] person-count mismatch ({len(persons)} vs {n_ref})")
        # ---- per-stage deltas (backbone → detection → HPH → verts) ----
        for key in STAGE_KEYS:
            rkey = f"stage_{key}"
            if rkey in ref.files and key in stages:
                st = _delta_stats(stages[key], ref[rkey])
                entry["stages"][key] = st
                if "error" not in st:
                    print(f"  stage {key:<11} max|Δ| {st['max_abs']:.3e} "
                          f"mean|Δ| {st['mean_abs']:.3e} (ref scale {st['ref_scale']:.3e})")
                else:
                    print(f"  stage {key:<11} SHAPE MISMATCH {st['ours']} vs {st['ref']}")
        for i in range(min(len(persons), n_ref)):
            v_ref = ref[f"v3d_{i}"]
            v_ours = np.asarray(persons[i]["v3d"])
            pel_ref = ref[f"transl_pelvis_{i}"].reshape(1, 3)
            pel_ours = np.asarray(persons[i]["transl_pelvis"]).reshape(1, 3)
            pve = 1000 * np.linalg.norm((v_ours - pel_ours) - (v_ref - pel_ref), axis=-1).mean()
            worst = max(worst, pve)
            entry["pve_mm"].append(float(pve))
            marker = "OK " if pve < args.tol_mm else "FAIL"
            print(f"  person {i}: PVE delta {pve:.3f} mm [{marker}]")
            if f"scores_{i}" in ref.files:
                ds = abs(float(persons[i]["scores"]) - float(ref[f"scores_{i}"]))
                print(f"             score delta {ds:.5f}")
        report["images"][name] = entry

    if n_imgs == 0:
        print("no dumps compared: provide --reference_dumps produced from the reference side")
        return 2
    ok = worst < args.tol_mm and count_mismatches == 0
    report["max_pve_mm"] = float(worst)
    report["count_mismatches"] = count_mismatches
    report["pass"] = bool(ok)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report written to {args.json_out}")
    print(f"\nmax PVE delta: {worst:.3f} mm (tolerance {args.tol_mm}); "
          f"{count_mismatches} image(s) with person-count mismatch")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
