"""Export a multiHMR model as a ``torch.export`` serving artifact
(``tools/export_model.py`` of the JAX package).

    python -m multihmr_tpu_torch.tools.export_model --model_name multiHMR_672_B \
        --out exported/672B [--checkpoint multiHMR_672_B.pt] [--batch 8] \
        [--det_thresh 0.3] [--nms 3] [--tp_mode heads] [--device cuda]

Run it on the device you deploy to (``--device cuda``, the default, bakes
the card's kernels into the artifact as operators). ``--checkpoint`` is a
reference ``multiHMR_*.pt``, converted as ``factory.build_model`` does;
without one the weights are seeded random ones, with a warning. The
backbone is cast to bf16 first (``utils/precision.py``). The artifact loads
with ``multihmr_tpu_torch.io.export.load_exported`` and serves with
``python -m multihmr_tpu_torch.cli.serve --artifact``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="multiHMR_896_L")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--det_thresh", type=float, default=0.3)
    p.add_argument("--nms", type=int, default=3)
    p.add_argument("--tp_mode", default="heads", choices=("heads", "ring"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA card; give --device cpu "
                               "to export for the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from multihmr_tpu_torch.factory import build_model
    from multihmr_tpu_torch.io.export import export_model
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    model = build_model(args.model_name, device=args.device, seed=0,
                        checkpoint=args.checkpoint, tp_mode=args.tp_mode)
    if args.checkpoint is None:
        print("warning: no checkpoint — exporting RANDOM weights", file=sys.stderr)
    cast_backbone_bf16(model.net)
    out = export_model(model, args.out, batch_size=args.batch, det_thresh=args.det_thresh,
                       nms_kernel_size=args.nms, name=args.model_name)
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported {args.model_name} ({args.tp_mode}, {args.device}) → {out} "
          f"({total / 1e6:.1f} MB)")
    return out


if __name__ == "__main__":
    main()
