"""Cells of the benchmark cut to a size the CPU runs in a second: a
32-wide, 2-block ViT at 224 px (a 16 x 16 grid), a 300-vertex body model,
small frames; the traffic files' other parameters as committed."""

import torch

from portbench import harness

FRAMES = [[64, 48], [96, 160]]

# The training cell: its harness is here, and BENCHMARK.json does not run it
# while the program's loss drops its distance term on some batches (PERF.md,
# Open questions). Its manifest entries, and at this size its limits, stay
# here so that its loop, reference and faults stay tested.
HELD = {
    "workloads": [{"name": "train_896L_b8", "config": "multiHMR_896_L",
                   "traffic": "train_bedlam_b8", "chips": 1}],
    "end_to_end": [{"name": "train_step_ms", "unit": "ms", "workloads": ["train_896L_b8"]}],
    "per_layer": [{"name": n, "unit": u, "workloads": ["train_896L_b8"]} for n, u in (
        ("train.adam_ms", "ms"), ("k1_roofline.train", "%"), ("k3_roofline.train", "%"),
        ("mfu.train", "%"), ("device_idle_pct.train", "%"))],
    "limits": {"train_896L_b8": {"grad_gap_p50": 0.02, "change_gap": 0.25,
                                 "change_gap_p50": 0.1}},
}


def manifest(held: bool = True) -> dict:
    m = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    if not held:
        return m
    names = {w["name"] for w in m["workloads"]}
    extra = [w for w in HELD["workloads"] if w["name"] not in names]
    if not extra:
        return m
    return dict(m, workloads=m["workloads"] + extra,
                end_to_end=m["end_to_end"] + HELD["end_to_end"],
                per_layer=m["per_layer"] + HELD["per_layer"])


def config() -> dict:
    cfg = harness.load_json(harness.ROOT / "configs" / "multiHMR_896_L.json")
    cfg.update(name="tiny", img_size=224, embed_dim=32, depth=2, num_heads=2,
               body_model=dict(cfg["body_model"], num_vertices=300))
    return cfg


def cell(workload: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace: bool = False):
    limits = None
    if not (harness.ROOT / "limits" / f"{workload}.json").exists():
        limits = HELD["limits"][workload]
    c = harness.cell_from_manifest(manifest(), workload, seed, seconds, trace, "cpu",
                                   limits=limits)
    c.config = config()
    c.traffic = dict(c.traffic, frame_sizes=FRAMES, per_size=2, trace_at_s=0.2, trace_s=0.3)
    if c.traffic["loop"] == "folder":
        c.traffic["batch"] = 2
    if c.traffic["loop"] == "train":
        c.traffic.update(batch=2, batches=4, checked_steps=3, max_humans=5)
    return c


def workloads(held: bool = True) -> list:
    """The cells of BENCHMARK.json, and with ``held`` the one held back."""
    return [w["name"] for w in manifest(held)["workloads"]]


def no_card() -> bool:
    return not torch.cuda.is_available()
