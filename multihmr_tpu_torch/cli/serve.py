"""Batching inference server CLI (``multihmr_tpu/cli/serve.py``).

    python -m multihmr_tpu_torch.cli.serve --model_name multiHMR_672_B \
        [--ckpt multiHMR_672_B.pt] [--port 8000] [--max_batch 8] \
        [--max_delay_ms 5] [--device cuda] [--tp_mode heads]
    python -m multihmr_tpu_torch.cli.serve --artifact exported/672B [--port 8000]

Unlike ``cli.app`` (the interactive single-image demo mirroring reference
app.py), this serves concurrent clients through a dynamic batcher that
coalesces requests into one fixed-shape batch on the card
(``serve/server.py``): POST /infer[?render=1], GET /healthz, GET /stats.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a
card it raises unless given ``--device cpu``) and ``--tp_mode`` (``heads``:
the ViT's channels-major stream, K1 + K2; ``ring``: the standard one, K5).
``--dp`` serves data-parallel over every local card (parallel/infer.py: a
replica of the weights each, each batch cut into equal chunks), ``max_batch``
rounded up to a multiple of their count; not with ``--artifact``. An
Anny-family name is refused at start: the server's batches, answers and
overlays are built for the SMPL-X family alone (the JAX server fails on
every request for such a name).

``--artifact``: serve a ``tools/export_model.py`` artifact (``io/export.py``).
The name, weights, stream, batch shape and detection parameters come from
the artifact, which must have been exported on ``--device``; flags that
differ from what it bakes in are ignored with a warning, and so is
``--ckpt``. The model object beside it only reads the persons back and
gives the overlay's faces (``factory.build_host_model``: the body model on
the host, a net without weights), so the card holds the weights once.
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str, default="multiHMR_672_B")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--artifact", type=str, default=None,
                   help="serve an exported artifact directory (tools/export_model.py)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--det_thresh", type=float, default=0.3)
    p.add_argument("--nms_kernel_size", type=int, default=3)
    p.add_argument("--max_queue", type=int, default=64,
                   help="bounded request queue: beyond this depth new "
                        "requests are shed with HTTP 429 + Retry-After "
                        "instead of queueing without bound (0 = unbounded)")
    p.add_argument("--deadline_s", type=float, default=30.0,
                   help="per-request dispatch deadline: a request still "
                        "queued after this many seconds fails with 503 "
                        "instead of wasting a device batch (0 = none)")
    p.add_argument("--json_only", action="store_true",
                   help="skip mesh-tensor readback (disables ?render=1); "
                        "cuts per-request device->host tail latency")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel serving over all local cards (--device cuda; the "
                   "one device otherwise): a replica of the weights on each, max_batch "
                   "rounded up to a multiple of their count")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--tp_mode", type=str, default="heads", choices=("heads", "ring"))
    return p.parse_args(argv)


def _artifact_meta(args) -> dict:
    """The artifact's meta.json; its name must be a known configuration."""
    from multihmr_tpu_torch.factory import SMPLX_NAMES
    from multihmr_tpu_torch.io.export import read_meta

    meta = read_meta(args.artifact)
    name = meta.get("name", "")
    if name not in SMPLX_NAMES and "anny" not in name:
        raise ValueError(
            f"artifact meta name {name!r} is not a known config: re-export with python -m "
            "multihmr_tpu_torch.tools.export_model (which records --model_name) or "
            "export_model(name=...)")
    # detection parameters and batch shape are baked into the artifact:
    # warn where a flag would silently diverge from it
    for flag, key in (("det_thresh", "det_thresh"), ("nms_kernel_size", "nms_kernel_size"),
                      ("max_batch", "batch_size")):
        want, have = getattr(args, flag), meta[key]
        if want != have:
            print(f"WARNING: --{flag}={want} ignored — the artifact bakes {key}={have}",
                  file=sys.stderr)
        setattr(args, flag, have)
    if args.ckpt is not None:
        print("WARNING: --ckpt ignored — weights come from the artifact", file=sys.stderr)
    args.model_name, args.tp_mode = name, meta["tp_mode"]
    return meta


def build_server(args):
    """(server, batcher) for parsed flags; raises for what is not ported."""
    if args.dp and args.artifact is not None:
        raise ValueError("--dp and --artifact are mutually exclusive")
    meta = None if args.artifact is None else _artifact_meta(args)
    if "anny" in args.model_name:
        raise ValueError(
            f"{args.model_name}: the server is built for the SMPL-X family alone, not the "
            "Anny family (the JAX server fails on every request for it); serve a SMPL-X "
            "configuration")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA card; give "
                               "--device cpu to serve on the CPU")
        # fp32 geometry as the JAX package's precision=HIGHEST: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from multihmr_tpu_torch.factory import build_host_model, build_model
    from multihmr_tpu_torch.serve import make_server
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    forward_fn = None
    if meta is not None:
        from multihmr_tpu_torch.io.export import as_model_forward, load_exported

        loaded = load_exported(args.artifact, device=args.device)
        model = build_host_model(args.model_name)
        if model.cfg.img_size != loaded.img_size:
            raise ValueError(f"artifact img_size {loaded.img_size} != {model.cfg.img_size} of "
                             f"the config {args.model_name!r}")
        forward_fn = as_model_forward(loaded)
    else:
        model = build_model(args.model_name, device=args.device, seed=0,
                            checkpoint=args.ckpt, tp_mode=args.tp_mode)
        if args.ckpt is None:
            print("WARNING: no checkpoint given — running with random weights")
        cast_backbone_bf16(model.net)  # inference: bf16 weight storage, after the load
    mesh = None
    if args.dp:  # every local card (JAX: make_mesh(model_parallel=1) over all chips)
        device = torch.device(args.device)
        mesh = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if device.type == "cuda" else [device])
        n = len(mesh)
        if args.max_batch % n:
            args.max_batch = -(-args.max_batch // n) * n
            print(f"--dp: rounding max_batch up to {args.max_batch} ({n} devices)")
    return make_server(
        model, port=args.port, max_batch=args.max_batch,
        det_thresh=args.det_thresh, nms_kernel_size=args.nms_kernel_size,
        max_delay_ms=args.max_delay_ms, forward_fn=forward_fn, json_only=args.json_only,
        mesh=mesh, max_queue=args.max_queue, deadline_s=args.deadline_s,
    )


def main(argv=None):
    args = parse_args(argv)
    srv, batcher = build_server(args)
    print(
        f"serving {args.model_name} on http://0.0.0.0:{srv.server_address[1]} "
        f"(POST /infer[?render=1], GET /healthz, GET /stats; "
        f"batch≤{args.max_batch}, window {args.max_delay_ms} ms, {args.device}, "
        f"{args.tp_mode})", flush=True,
    )
    try:
        srv.serve_forever()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
