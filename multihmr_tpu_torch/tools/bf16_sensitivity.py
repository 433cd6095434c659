"""bf16-backbone sensitivity: how many millimetres of vertex error does the
bf16 ViT contribute, against the 0.5 mm PVE parity bar?
(``tools/bf16_sensitivity.py`` of the JAX package)

    python -m multihmr_tpu_torch.tools.bf16_sensitivity [--configs multiHMR_672_S,...]
        [--images 2] [--seeds 2] [--persons 3] [--ckpt multiHMR_896_L.pt]
        [--json_out PATH] [--device cuda]

The same weights, images and person slots through two models: a true
fp32-compute one (``compute_dtype="float32"``: the ViT computes in fp32,
K1's fp32 path on the channels-major stream) and the production one (the
bf16 backbone of ``cast_backbone_bf16``, K1's bf16 path). The detections
are injected through ``is_training=True, gt_det=`` so that both regress
the same query cells and the delta is the backbone's arithmetic alone. Per
valid slot, the mean vertex distance between the two ``v3d`` is reported
raw (it holds the exp-decoded camera distance, the most bf16-sensitive
output) and centred at each side's pelvis (the PVE the parity bar is
defined on, reference train.py:373-385), as p50, p99 and max.

Random weights by default, a seed each (``--seeds``); ``--ckpt`` re-runs
the study on real weights. Images are numpy normals seeded per (seed,
image). Prints one JSON line per configuration; ``--json_out`` also
writes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from multihmr_tpu_torch.config import named_config
from multihmr_tpu_torch.factory import build_model
from multihmr_tpu_torch.io.preprocessing import get_camera_parameters
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.ops.detection import Detections
from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

DEFAULT_CONFIGS = (
    "multiHMR_672_S",
    "multiHMR_672_B",
    "multiHMR_672_L",
    "multiHMR_896_L",
    "multiHMR_1288_L_bedlam",
)


def injected_slots(g: int, capacity: int, n_persons: int):
    """The JAX tool's ``n_persons`` distinct central-ish cells of the g x g
    grid (``np.random.default_rng(0)``) as (rows, cols, valid) ``[1, capacity]``."""
    rng = np.random.default_rng(0)
    cells = rng.choice(g * g // 2, size=n_persons, replace=False) + g * g // 4
    rows = np.zeros((1, capacity), np.int64)
    cols = np.zeros((1, capacity), np.int64)
    rows[0, :n_persons] = cells // g
    cols[0, :n_persons] = cells % g
    valid = np.zeros((1, capacity), np.float32)
    valid[0, :n_persons] = 1.0
    return rows, cols, valid


def image(S: int, seed: int, img: int) -> np.ndarray:
    """Image ``img`` of weight seed ``seed``: normals [1, S, S, 3], float32."""
    return np.random.default_rng(1000 + seed * 100 + img).standard_normal(
        (1, S, S, 3), dtype=np.float32)


def twin(model: MultiHMR, cfg) -> MultiHMR:
    """``model``'s weights (copied) under ``cfg``, on the same device."""
    with torch.device("meta"):
        net = MultiHMRNet(cfg, tp_mode=model.tp_mode)
    net.load_state_dict({k: v.clone() for k, v in model.net.state_dict().items()},
                        strict=True, assign=True)
    return MultiHMR(cfg, model.body_model, net=net.eval(), tp_mode=model.tp_mode)


def compare(model16: MultiHMR, model32: MultiHMR, x: np.ndarray, n_persons: int):
    """One image through both models with the injected slots: per person the
    mean |v3d| distance in mm, raw and pelvis-centred, and the fp32 side's
    ``v3d [n_persons, V, 3]``."""
    cfg = model32.cfg
    device = model32.body_model.v_template.device
    rows, cols, valid = (torch.from_numpy(a).to(device)
                         for a in injected_slots(cfg.grid_size, cfg.max_people, n_persons))
    det = Detections(rows=rows, cols=cols, scores=valid, valid=valid)
    xt = torch.from_numpy(x).to(device)
    K = torch.from_numpy(get_camera_parameters(cfg.img_size, fov=60)).to(device)
    with torch.inference_mode():
        outs = [m.forward(xt, K, is_training=True, gt_det=det) for m in (model32, model16)]
    (v32, p32), (v16, p16) = (
        (o["v3d"][0, :n_persons].double().cpu().numpy(),
         o["transl_pelvis"][0, :n_persons].double().cpu().numpy().reshape(n_persons, 1, 3))
        for o in outs)
    raw = 1000.0 * np.linalg.norm(v32 - v16, axis=-1).mean(-1)
    cen = 1000.0 * np.linalg.norm((v32 - p32) - (v16 - p16), axis=-1).mean(-1)
    return raw.tolist(), cen.tolist(), v32


def run_config(name: str, n_images: int, n_seeds: int, n_persons: int, ckpt: str = None,
               device: str = "cuda") -> dict:
    cfg32 = dataclasses.replace(named_config(name), compute_dtype="float32")
    raw_mm, centered_mm = [], []
    model32 = None
    for seed in range(n_seeds):
        if model32 is None or ckpt is None:  # a file: its weights for every seed
            model32 = model16 = None  # free the previous seed's before the next
            model32 = build_model(name, device=device, seed=seed, cfg=cfg32, checkpoint=ckpt)
            model16 = twin(model32, named_config(name))
            cast_backbone_bf16(model16.net)
        for img in range(n_images):
            raw, cen, _ = compare(model16, model32, image(cfg32.img_size, seed, img), n_persons)
            raw_mm.extend(raw)
            centered_mm.extend(cen)

    def stats(v):
        a = np.asarray(v)
        return {"p50": round(float(np.percentile(a, 50)), 3),
                "p99": round(float(np.percentile(a, 99)), 3),
                "max": round(float(a.max()), 3)}

    return {
        "config": name,
        "samples": len(raw_mm),
        "v3d_raw_mm": stats(raw_mm),  # holds the exp-decoded distance
        "v3d_pelvis_centered_mm": stats(centered_mm),  # the PVE-bar quantity
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(DEFAULT_CONFIGS))
    p.add_argument("--images", type=int, default=2)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--persons", type=int, default=3)
    p.add_argument("--ckpt", default=None,
                   help="real checkpoint (re-run the study on real weights)")
    p.add_argument("--json_out", default=None, help="also write the results here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    results = {}
    for name in args.configs.split(","):
        r = run_config(name.strip(), args.images, args.seeds, args.persons, ckpt=args.ckpt,
                       device=args.device)
        results[name.strip()] = r
        print(json.dumps(r), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"bf16_sensitivity": {
                "weights": "random-init" if args.ckpt is None else args.ckpt,
                "per_config": results}}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
