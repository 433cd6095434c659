"""Batching inference server CLI (``multihmr_tpu/cli/serve.py``).

    python -m multihmr_tpu_torch.cli.serve --model_name multiHMR_672_B \
        [--ckpt multiHMR_672_B.pt] [--port 8000] [--max_batch 8] \
        [--max_delay_ms 5] [--device cuda] [--tp_mode heads]

Unlike ``cli.app`` (the interactive single-image demo mirroring reference
app.py), this serves concurrent clients through a dynamic batcher that
coalesces requests into one fixed-shape batch on the card
(``serve/server.py``): POST /infer[?render=1], GET /healthz, GET /stats.

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a
card it raises unless given ``--device cpu``) and ``--tp_mode`` (``heads``:
the ViT's channels-major stream, K1 + K2; ``ring``: the standard one, K5).
``--artifact`` (an exported model, ROADMAP M10) and ``--dp`` (data-parallel
serving, M11) are not ported and raise. An Anny-family name is refused at
start: the server reads back ``extract_persons(out, fields)``, which
``MultiHMRAnny`` does not take (the JAX server fails on every request for
such a name).
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", type=str, default="multiHMR_672_B")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--artifact", type=str, default=None,
                   help="serve an exported artifact directory (not ported: M10)")
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
                   help="data-parallel serving over all local cards (not ported: M11)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--tp_mode", type=str, default="heads", choices=("heads", "ring"))
    return p.parse_args(argv)


def build_server(args):
    """(server, batcher) for parsed flags; raises for what is not ported."""
    if args.artifact is not None:
        raise NotImplementedError("--artifact (an exported model) is not ported yet: "
                                  "ROADMAP M10")
    if args.dp:
        raise NotImplementedError("--dp (data-parallel serving) is not ported yet: "
                                  "ROADMAP M11")
    if "anny" in args.model_name:
        raise ValueError(
            f"{args.model_name}: the server reads back extract_persons(out, fields), "
            "which the Anny family does not take (the JAX server fails on every request "
            "for it); serve a SMPL-X configuration")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA card; give "
                               "--device cpu to serve on the CPU")
        # fp32 geometry as the JAX package's precision=HIGHEST: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.serve import make_server
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    model = build_model(args.model_name, device=args.device, seed=0, checkpoint=args.ckpt,
                        tp_mode=args.tp_mode)
    if args.ckpt is None:
        print("WARNING: no checkpoint given — running with random weights")
    cast_backbone_bf16(model.net)  # inference: bf16 weight storage, after the load
    return make_server(
        model, port=args.port, max_batch=args.max_batch,
        det_thresh=args.det_thresh, nms_kernel_size=args.nms_kernel_size,
        max_delay_ms=args.max_delay_ms, json_only=args.json_only,
        max_queue=args.max_queue, deadline_s=args.deadline_s,
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
