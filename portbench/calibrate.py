"""Readings of the compared numbers over many seeds, for the program and
for the control, in one process: what the limits in ``limits/`` are set
from (the largest of the program's sound runs, the least of the control's).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control_seeds 7,8,9 --seconds 3 [--out calibrate.jsonl]

Each seed builds the cell anew (its weights, body model and inputs), runs a
short window at the cell's own load, and compares as a run does; the
control stands in for the program on the images that window sampled.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def half_batch():
    """every training step over the first half of its batch"""
    from multihmr_tpu_torch.train import trainer

    sound = trainer.to_device
    trainer.to_device = lambda batch, device: {
        k: v[: v.shape[0] // 2] for k, v in sound(batch, device).items()}


def one_person():
    """every answer keeps its first person alone"""
    from multihmr_tpu_torch.models import multihmr

    sound = multihmr.persons_from_host
    multihmr.persons_from_host = lambda host: [image[:1] for image in sound(host)]


FAULTS = {"half_batch": half_batch, "one_person": one_person}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant a fault in the program: " + "; ".join(
                       f"{k}: {f.__doc__}" for k, f in sorted(FAULTS.items())))
    args = p.parse_args(argv)
    import torch

    from portbench import harness
    from multihmr_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    cuda_lib.build()
    manifest = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    if args.fault:
        FAULTS[args.fault]()
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = []
    for kind, seed in ([("program", s) for s in seeds(args.seeds)]
                       + [("control", s) for s in seeds(args.control_seeds)]):
        cell = harness.cell_from_manifest(manifest, args.workload, seed, args.seconds, False,
                                          "cuda")
        drv = harness.loop(cell)
        t0 = time.perf_counter()
        state = drv.setup(cell)
        setup_s = time.perf_counter() - t0
        out = drv.window(cell, state)
        numbers = drv.check(cell, state) if kind == "program" else drv.control(cell, state)
        row = {"kind": kind if args.fault is None else args.fault, "seed": seed,
               "numbers": numbers, "setup_s": setup_s,
               "metrics": out["metrics"], "attempted": out["attempted"],
               "failed": out["failed"], "notes": out.get("notes", {}),
               "memory_peak_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    names = sorted({k for r in rows for k in r["numbers"]})
    summary = {}
    for k in names:
        prog = [r["numbers"][k] for r in rows if r["kind"] != "control" and k in r["numbers"]]
        ctrl = [r["numbers"][k] for r in rows if r["kind"] == "control" and k in r["numbers"]]
        summary[k] = {("fault_min" if args.fault else "program_max"):
                      (min if args.fault else max)(prog, default=None),
                      "control_min": min(ctrl, default=None)}
    print(json.dumps({"workload": args.workload, "card": harness.power_line(),
                      "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(dict(r, workload=args.workload)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
