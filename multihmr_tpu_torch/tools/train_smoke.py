"""Train-step smoke test of the port (``tools/train_smoke.py`` of the JAX package).

    python -m multihmr_tpu_torch.tools.train_smoke --model multiHMR_896_L --batch 2 --steps 5 \
        [--remat_policy none|mlp|block] [--ops 15]

Builds the named configuration with seeded random weights and the synthetic
SMPL-X-sized body model (``max_people`` 8), makes the JAX tool's seeded
synthetic batch, and runs ``--steps`` Adam steps through ``make_train_step``:
forward, loss, the backward (flash-attention backward kernel K3), update. Prints each
step's loss and time, and on a card the peak device memory. Steps 0 and 1
warm up (the kernel build, the allocator's first blocks and Adam's state:
step 1 measured up to 1 s on the card); the median covers the later steps,
which needs ``--steps`` of at least 3. On a card
the step times come from CUDA events around each step (device time, the
host running ahead); on the CPU from the host clock. ``--ops N`` (on a
card) then profiles two more steps with ``torch.profiler``: the wall time per
step (host clock, ending in a synchronize), the device's busy time (union
of its kernel intervals) and share, and the N kernels with the most device
time per step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from multihmr_tpu_torch.config import named_config
from multihmr_tpu_torch.factory import build_model
from multihmr_tpu_torch.train.trainer import make_train_step, to_device

REMAT = ("none", "mlp", "block")


def synthetic_batch(B: int, Kh: int, S: int, seed: int = 0) -> dict:
    """The JAX tool's seeded batch: noise image, K with focal 900, people
    around 4 m in front of the camera, each valid with probability 0.6."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(B, S, S, 3)),
        "K": np.broadcast_to(np.array([[900.0, 0, S / 2], [0, 900.0, S / 2], [0, 0, 1]]),
                             (B, 3, 3)),
        "gt_pose": rng.normal(scale=0.2, size=(B, Kh, 53, 3)),
        "gt_shape": rng.normal(size=(B, Kh, 10)),
        "gt_transl": rng.normal(scale=0.3, size=(B, Kh, 3)) + np.array([0, 0, 4.0]),
        "gt_valid": (rng.uniform(size=(B, Kh)) > 0.4).astype(np.float32),
    }


def train_config(model: str, remat_policy: str = "none", max_people: int = 8):
    return dataclasses.replace(
        named_config(model), remat=remat_policy != "none",
        remat_policy=remat_policy if remat_policy != "none" else "block",
        max_people=max_people)


def run(model: str = "multiHMR_896_L", batch: int = 2, steps: int = 5,
        remat_policy: str = "none", device: str = "cuda", lr: float = 5e-6,
        ops: int = 0, log=print) -> dict:
    """Build, then ``steps`` train steps; returns the losses, the per-step
    ms, and the peak device memory in GiB (None on the CPU)."""
    cfg = train_config(model, remat_policy)
    mhmr = build_model(model, device=device, seed=0, cfg=cfg)
    opt = torch.optim.Adam(mhmr.net.parameters(), lr=lr, eps=1e-8)
    step = make_train_step(mhmr, opt)
    b = to_device(synthetic_batch(batch, cfg.max_people, cfg.img_size), device)
    on_card = torch.device(device).type == "cuda"
    log(f"{model}: img={cfg.img_size} tokens={cfg.num_patches + 1} batch={batch} "
        f"remat={remat_policy} params={sum(p.numel() for p in mhmr.net.parameters()) / 1e6:.1f}M")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    terms, ms = [], []
    for i in range(steps):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            terms.append(step(b, 0))
            end.record()
            ms.append((start, end))
        else:
            t0 = time.perf_counter()
            terms.append(step(b, 0))
            ms.append((time.perf_counter() - t0) * 1e3)
    if on_card:
        torch.cuda.synchronize(device)
        ms = [s.elapsed_time(e) for s, e in ms]
    losses = [float(t["total"]) for t in terms]
    for i, (loss, t) in enumerate(zip(losses, ms)):
        log(f"step {i}: loss={loss:.4f} {t:.3f} ms{' (warm-up)' if i < 2 else ''}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None
    median = float(np.median(ms[2:])) if len(ms) > 2 else None
    if median is not None:
        log(f"median step {median:.3f} ms over steps 2-{steps - 1} "
            f"({'CUDA events' if on_card else 'host clock'})"
            + (f"; peak memory {peak:.2f} GiB" if peak is not None else ""))
    if ops and on_card:
        profile_steps(step, b, ops, log)
    return {"losses": losses, "ms": ms, "median_ms": median, "peak_gib": peak,
            "finite": all(float(t["finite"]) == 1.0 for t in terms)}


def busy_us(events) -> float:
    """Union of the device kernels' [start, end) intervals among profiler
    events, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_steps(step, batch: dict, top: int, log=print, steps: int = 2) -> None:
    """Device time per kernel and the busy share over ``steps`` train steps."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_ms = busy_us(prof.events()) / 1e3 / steps
    log(f"profiled: wall {wall_ms:.1f} ms/step, device busy {busy_ms:.1f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f} %)")
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log(f"{'ms/step':>9} {'calls/step':>10}  kernel")
    for e in rows[:top]:
        log(f"{e.self_device_time_total / 1e3 / steps:9.3f} {e.count / steps:10.1f}  "
            f"{e.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="multiHMR_896_L")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--remat_policy", default="none", choices=REMAT,
                    help="'none'; 'mlp': recompute only each block's MLP; 'block': "
                         "recompute whole blocks (the flash forward runs twice)")
    ap.add_argument("--ops", type=int, default=0, metavar="N",
                    help="profile two more steps and print the N kernels with the "
                         "most device time (card only)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = run(args.model, args.batch, args.steps, args.remat_policy, args.device,
              ops=args.ops)
    if not all(np.isfinite(res["losses"])) or not res["finite"]:
        print("non-finite loss")
        return 1
    print("train smoke OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
