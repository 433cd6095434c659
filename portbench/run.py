"""Run one cell of the benchmark of ``multihmr_tpu_torch`` on this machine's card(s).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the card checked, the kernel library built or found, the model and
its inputs made from the seed, the cell's shapes warmed up), then a window
of ``--seconds``, then the comparison with the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit (also the last lines
of standard error). Without a card, or with fewer than the cell needs, it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))
# caches of compilers the program or its libraries may use, at fixed paths
# inside the checkout; transformers (if anything loads it) must not load JAX
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(CHECKOUT / ".portbench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    manifest = harness.load_json(CHECKOUT / "BENCHMARK.json")
    chips = next((w["chips"] for w in manifest["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        harness.log(f"no workload {args.workload!r}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from multihmr_tpu_torch.ops import cuda_lib

    _, build_s = cuda_lib.build()
    harness.log(f"kernel library: {'built in %.1f s' % build_s if build_s else 'reused'}; "
                f"card: {harness.power_line()}")
    cell = harness.cell_from_manifest(manifest, args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda")
    result = harness.run(cell, T_START)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
