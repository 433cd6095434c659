"""Profile a named configuration on the card (``tools/profile_model.py`` of the JAX package).

    python -m multihmr_tpu_torch.tools.profile_model --model_name multiHMR_896_L [--batch 1]
        [--iters 8] [--trace DIR] [--stages] [--ops N] [--tp_mode heads|ring] [--device cuda]

Builds the configuration with seeded random weights and the bf16 backbone
(``cast_backbone_bf16``, as serving does; TF32 off), and prints the
slope-based latency of the forward (``utils/profiling.py::latency_stats``)
as ms per batch, ms per image and images per second, with the card's name
and power limit. ``--stages`` also times the ViT alone (the rest is the
difference). ``--trace DIR`` writes a Chrome trace of three forwards
there; ``--ops N`` takes that trace too and prints the N kernels with the
most device time per forward, the device's busy time per forward, and the
launches of each hand-written kernel per forward (``cuda_lib.LAUNCHES``).
The latency is the back-to-back eager pace, the host's where its dispatch
is slower than the device; the busy time is the device's own.
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile

import torch

from multihmr_tpu_torch.factory import build_model
from multihmr_tpu_torch.ops import cuda_lib
from multihmr_tpu_torch.utils.precision import cast_backbone_bf16
from multihmr_tpu_torch.utils.profiling import (
    busy_ms, device_line, device_op_table, latency_stats, profile_trace, tensor_leaves,
)

PROFILED_RUNS = 3


def inputs(S: int, B: int, device):
    """A seeded normal image batch [B, S, S, 3] and the JAX tool's K (focal 754)."""
    x = torch.randn((B, S, S, 3), generator=torch.Generator().manual_seed(1)).to(device)
    K = torch.tensor([[754.0, 0, S / 2], [0, 754.0, S / 2], [0, 0, 1.0]], device=device)
    return x, K.expand(B, 3, 3).contiguous()


def launches_since(before: collections.Counter, runs: int = 1) -> dict:
    """Each kernel's launches (``cuda_lib.LAUNCHES``) since ``before``, per run."""
    return {k: (v - before[k]) / runs for k, v in cuda_lib.LAUNCHES.items() if v > before[k]}


def all_finite(out) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensor_leaves(out) if t.is_floating_point())


def run(model_name: str = "multiHMR_896_L", batch: int = 1, iters: int = 8,
        stages: bool = False, ops: int = 0, trace=None, device: str = "cuda",
        tp_mode: str = "heads", repeats: int = 5, log=print) -> dict:
    """The tool's work; returns {"ms", "vit_ms", "busy_ms", "launches" (of
    the first forward, by kernel), "finite", "peak_gib", "card"} (None where
    not taken)."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = device_line(device)
    model = build_model(model_name, device=device, seed=0, tp_mode=tp_mode)
    cast_backbone_bf16(model.net)
    S, B = model.cfg.img_size, batch
    x, K = inputs(S, B, device)
    fwd = lambda x: model.forward(x, K)  # noqa: E731  (K closed over: x is perturbed)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = collections.Counter(cuda_lib.LAUNCHES)
    with torch.inference_mode():
        finite = all_finite(fwd(x))
    launches = launches_since(before)
    r = latency_stats(fwd, (x,), iters=iters, repeats=repeats)
    res = {"ms": r["p50_ms"], "vit_ms": None, "busy_ms": None, "launches": launches,
           "finite": finite, "card": card,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None}
    log(f"{model_name} B={B} ({tp_mode}): {r['p50_ms']:.2f} ms/batch"
        f" = {r['p50_ms'] / B:.2f} ms/img = {1000 * B / r['p50_ms']:.1f} img/s [{card}]")

    if stages:
        vit = lambda x: model.net.backbone(x)["patch_tokens"]  # noqa: E731
        rv = latency_stats(vit, (x,), iters=iters, repeats=repeats)
        res["vit_ms"] = rv["p50_ms"]
        log(f"  vit: {rv['p50_ms']:.2f} ms  (rest: {r['p50_ms'] - rv['p50_ms']:.2f} ms)")

    if trace or ops:
        logdir = trace or tempfile.mkdtemp(prefix="multihmr_trace_")
        with torch.inference_mode():
            fwd(x)
            before = collections.Counter(cuda_lib.LAUNCHES)
            with profile_trace(logdir) as prof:
                for _ in range(PROFILED_RUNS):
                    fwd(x)
        launches = launches_since(before, PROFILED_RUNS)
        log(f"trace written to {logdir}")
        if on_card:
            res["busy_ms"] = busy_ms(prof.events()) / PROFILED_RUNS
            log(f"device busy {res['busy_ms']:.2f} ms per forward; kernel launches per "
                f"forward: " + (", ".join(f"{k} {v:g}" for k, v in sorted(launches.items()))
                                or "none"))
        if ops:
            log(f"{'ms/run':>9}  {'count':>5}  op")
            for name, ms, cnt in device_op_table(logdir, top=ops, runs=PROFILED_RUNS):
                log(f"{ms:9.3f}  {cnt:5d}  {name[:80]}")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_name", default="multiHMR_896_L")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--trace", default=None, help="write a Chrome trace of 3 forwards here")
    p.add_argument("--stages", action="store_true", help="also time the ViT alone")
    p.add_argument("--ops", type=int, default=0, metavar="N",
                   help="capture a trace and print the top-N ops by device time")
    p.add_argument("--tp_mode", default="heads", choices=("heads", "ring"),
                   help="'heads': the ViT's channels-major stream (K1, K2); 'ring': its "
                        "standard stream (K5)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = run(args.model_name, args.batch, args.iters, args.stages, args.ops,
              args.trace and os.path.abspath(args.trace), args.device, args.tp_mode)
    return 0 if res["finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
