"""Detection-capacity sweep: what does raising K (``max_people``) cost?
(``tools/sweep_capacity.py`` of the JAX package)

    python -m multihmr_tpu_torch.tools.sweep_capacity [--configs multiHMR_672_B,multiHMR_896_L]
        [--capacities 16,32,64] [--iters 8] [--json_out PATH] [--device cuda]

The model keeps static ``[B, K]`` person slots and truncates beyond K
(``models/multihmr.py::extract_persons``); the head and the body model run
on every slot. Per configuration and capacity K: the first call's seconds
and the steady-state ms per image (``utils/profiling.py::latency_stats``),
seeded random weights, the bf16 backbone, batch 1. Prints one JSON line per
point; ``--json_out`` also writes them, keyed by configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from multihmr_tpu_torch.config import named_config
from multihmr_tpu_torch.factory import build_model
from multihmr_tpu_torch.io.preprocessing import get_camera_parameters
from multihmr_tpu_torch.utils.precision import cast_backbone_bf16
from multihmr_tpu_torch.utils.profiling import latency_stats


def run_point(name: str, capacity: int, device: str = "cuda", iters: int = 8,
              repeats: int = 5) -> dict:
    """{"capacity", "ms_per_img", "first_call_s"}. ``first_call_s`` is the
    wall of the first forward after the build, to its last output on the
    host: no XLA compile happens here, so it holds the allocator's first
    blocks, the first launch of each kernel (the library is loaded, and
    built if it was not) and the host's first pass over the Python code."""
    cfg = dataclasses.replace(named_config(name), max_people=capacity)
    model = build_model(name, device=device, seed=0, cfg=cfg)
    cast_backbone_bf16(model.net)
    S = cfg.img_size
    x = torch.randn((1, S, S, 3), generator=torch.Generator().manual_seed(1)).to(device)
    K = torch.from_numpy(get_camera_parameters(S, fov=60)).to(device)
    fwd = lambda x: model.forward(x, K)  # noqa: E731

    t0 = time.perf_counter()
    with torch.inference_mode():
        fwd(x)["v3d"].cpu()
    first_call_s = time.perf_counter() - t0

    r = latency_stats(fwd, (x,), iters=iters, repeats=repeats)
    return {
        "capacity": capacity,
        "ms_per_img": round(r["p50_ms"], 2),
        "first_call_s": round(first_call_s, 3),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default="multiHMR_672_B,multiHMR_896_L")
    p.add_argument("--capacities", default="16,32,64")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--json_out", default=None, help="also write the points here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    results = {}
    for name in args.configs.split(","):
        name = name.strip()
        results[name] = []
        for cap in (int(c) for c in args.capacities.split(",")):
            r = run_point(name, cap, args.device, args.iters)
            results[name].append(r)
            print(json.dumps({"config": name, **r}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"k_capacity": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
