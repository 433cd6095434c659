"""The benchmark's core: a cell, its set-up, its window, its check, its line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
file ``configs/<config>.json`` and a traffic file ``traffic/<traffic>.json``.
The traffic file names a ``loop`` (``loops/<loop>.py``, one general
loop per kind of use: ``train``, ``folder``) and its
parameters. Each per-layer metric is a reader ``metrics/<metric>.py``, and
each cell's limits of the comparison that decides ``correct`` are
``limits/<workload>.json``. Everything is found by name, so a cell or a
metric is added with files and entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multihmr_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``multihmr_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: list  # the BENCHMARK.json entries of this cell's per-layer metrics
    end_to_end: list  # and of its end-to-end metrics
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1

    def model_config(self):
        return model_config(self.config)


def model_config(c: dict):
    """The port's configuration of a configuration file. A name the port
    knows must give the same sizes as the port's ``named_config``."""
    from multihmr_tpu_torch.config import ModelConfig, ViTConfig, named_config

    vit = ViTConfig(embed_dim=c["embed_dim"], depth=c["depth"], num_heads=c["num_heads"],
                    patch_size=c["patch_size"], mlp_ratio=c["mlp_ratio"])
    cfg = ModelConfig(backbone=c["backbone"], img_size=c["img_size"],
                      camera_embedding_num_bands=c["camera_embedding_num_bands"],
                      camera_embedding_max_resolution=c["camera_embedding_max_resolution"],
                      fovn=c["fovn"], xat_depth=c["xat_depth"], xat_num_heads=c["xat_num_heads"],
                      num_betas=c["num_betas"], nrot=c["nrot"], max_people=c["max_people"],
                      compute_dtype=c["compute_dtype"], param_dtype=c["param_dtype"],
                      vit_override=vit)
    try:
        named = named_config(c["name"])
    except KeyError:
        return cfg
    same = dataclasses.replace(named, vit_override=None)
    if (dataclasses.replace(cfg, vit_override=None) != same
            or dataclasses.astuple(named.vit)[:5] != dataclasses.astuple(vit)[:5]
            or cfg.hph != named.hph):
        raise ValueError(f"configs/{c['name']}.json differs from the port's named_config")
    return named


def cell_from_manifest(manifest: dict, workload: str, seed: int, seconds: float, trace: bool,
                       device, root: Path = ROOT, limits: dict | None = None) -> Cell:
    """The cell ``workload`` of ``manifest``; its limits from
    ``limits/<workload>.json`` unless given."""
    w = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{w['traffic']}.json")
    if limits is None:
        limits = load_json(root / "limits" / f"{workload}.json")
    reports = lambda m: "workloads" not in m or workload in m["workloads"]  # noqa: E731
    return Cell(name=workload, config=config, traffic=traffic, limits=limits,
                per_layer=[m for m in manifest["per_layer"] if reports(m)],
                end_to_end=[m for m in manifest["end_to_end"] if reports(m)],
                seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
                chips=w["chips"])


def loop(cell: Cell):
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")


def read_metric(name: str, ctx: dict):
    mod = load_module(ROOT / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: [value, limit]}) for every number
    that ``limits`` names; a number that the run did not produce (``None``:
    the sampled answers held nothing to compare it on) or that is not
    finite fails."""
    checks = {k: [numbers.get(k), lim] for k, lim in limits.items()}
    ok = all(v is not None and math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks


def device_info(cell: Cell) -> dict:
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
            "count": cell.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(cell.device))}


def power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run(cell: Cell, t_start: float) -> dict:
    """Set up, measure, check: the result's dict. ``t_start``: the
    perf_counter reading at process start."""
    drv = loop(cell)
    if cell.trace:  # before the program starts threads of its own
        from portbench.trace import warm_profiler

        warm_profiler()
    state = drv.setup(cell)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"set-up loaded {found}")
    setup_s = time.perf_counter() - t_start
    out = drv.window(cell, state)
    device = device_info(cell)
    ctx = {"cell": cell, "state": state, "window": out, "trace": out.get("trace")}
    metrics = {}
    if cell.trace:
        tr = out["trace"]
        if tr is None:
            raise RuntimeError("the traced sub-window did not close inside the window")
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    log(f"window: {out['attempted']} attempted, {out['failed']} failed; "
        + ", ".join(f"{k} {v}" for k, v in out.get("notes", {}).items()))
    numbers = drv.check(cell, state)
    log("compared with the reference: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    ok, checks = judged(numbers, cell.limits)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    result = {"correct": bool(ok and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = checks
    return result
