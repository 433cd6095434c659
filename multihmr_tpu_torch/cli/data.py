"""Dataset utilities CLI (``multihmr_tpu/cli/data.py``): create_annots,
visualize, dataloader and create_jpeg.

    python -m multihmr_tpu_torch.cli.data create_annots --dataset ehf
    python -m multihmr_tpu_torch.cli.data visualize --dataset bedlam --index 50 [--device cuda]
    python -m multihmr_tpu_torch.cli.data dataloader --dataset bedlam --n 100
    python -m multihmr_tpu_torch.cli.data create_jpeg --root_dir data/BEDLAM --target_size 512

The commands of the reference datasets' modules (datasets/bedlam.py:315-485,
ehf.py:158-210, threedpw.py:219-261), as the JAX package has them, on the
port's ``data/`` (annotation caches in ``data/*.pkl`` of the working
directory), ``render/`` and body model. ``visualize`` poses the GT SMPL-X
bodies with ``bodymodel/core.py::lbs_forward`` on ``--device`` (default
``cuda``, with TF32 off: the JAX package's fp32 HIGHEST) and writes
``<dataset>_vis_<index>.png``, the image beside the GT meshes drawn over it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def get_dataset(name: str, img_size: int, force_build: bool = False, training=False):
    if name == "bedlam":
        from multihmr_tpu_torch.data.bedlam import BEDLAM

        return BEDLAM(
            split="training" if training else "validation",
            training=training, img_size=img_size, force_build_dataset=force_build,
        )
    if name == "ehf":
        from multihmr_tpu_torch.data.ehf import EHF

        return EHF(img_size=img_size, force_build_dataset=force_build)
    if name == "3dpw":
        from multihmr_tpu_torch.data.threedpw import THREEDPW

        return THREEDPW(img_size=img_size, force_build_dataset=force_build)
    raise ValueError(name)


def cmd_create_annots(args):
    ds = get_dataset(args.dataset, args.img_size, force_build=True, training=args.training)
    print(f"built annotations: {ds!r}")


def gt_meshes(humans: list, bm, device) -> list:
    """Each GT person's vertices ``[V, 3]`` (numpy): the annotation's own
    (EHF, 3DPW), or its SMPL-X parameters posed by ``bm`` on ``device``
    (BEDLAM), shifted by its translation."""
    from multihmr_tpu_torch.bodymodel.core import lbs_forward
    from multihmr_tpu_torch.ops.rotations import rotvec_to_rotmat

    if not humans:
        return []
    if "smplx_vertices" in humans[0]:
        return [h["smplx_vertices"] for h in humans]
    if "smplx_root_pose" not in humans[0]:
        return []
    out = []
    for h in humans:
        pose = np.concatenate(
            [h["smplx_root_pose"], h["smplx_body_pose"], h["smplx_jaw_pose"],
             h["smplx_leye_pose"], h["smplx_reye_pose"],
             h["smplx_left_hand_pose"], h["smplx_right_hand_pose"]], 0)
        with torch.inference_mode():
            rots = rotvec_to_rotmat(torch.as_tensor(pose[None], dtype=torch.float32,
                                                    device=device))
            betas = torch.as_tensor(h["smplx_shape"][None, :10], dtype=torch.float32,
                                    device=device)
            verts = lbs_forward(bm, rots, betas)["vertices"]
        out.append(verts[0].cpu().numpy() + h["smplx_transl"])
    return out


def cmd_visualize(args):
    """Render GT meshes over the image through the real render path — the
    reference's GT-correctness check (datasets/bedlam.py:319-363)."""
    from PIL import Image

    from multihmr_tpu_torch.factory import load_body_model
    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD
    from multihmr_tpu_torch.render import render_meshes

    device = torch.device(args.device)
    if device.type == "cuda":  # fp32 geometry, as the JAX package's HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ds = get_dataset(args.dataset, args.img_size, training=args.training)
    x, annot = ds[args.index]
    img = np.clip((x * IMG_NORM_STD + IMG_NORM_MEAN) * 255, 0, 255).astype(np.uint8)

    bm = load_body_model(device, 11)
    verts_list = gt_meshes(annot["humans"], bm, device)
    faces = bm.faces.cpu().numpy()
    arr = render_meshes(img, verts_list, [faces] * len(verts_list), annot["K"])
    out_fn = f"{args.dataset}_vis_{args.index}.png"
    Image.fromarray(np.concatenate([img, arr], 1)).save(out_fn)
    print(f"saved {out_fn} ({len(verts_list)} humans)")


def create_jpeg(root_dir: str, target_size: int | None = 512,
                log_freq: int = 1000, log_fn=print) -> int:
    """Convert every ``.png`` under ``root_dir`` to a JPEG, downscaling the
    long side to ``target_size`` (reference datasets/bedlam.py:449-485 —
    BEDLAM ships 1280×720 PNGs; training reads the smaller JPEGs).

    Output naming matches the reference: ``name_<target>.jpg`` next to the
    source when resizing, ``name.jpg`` when ``target_size`` is None.
    Returns the number of images converted.
    """
    from PIL import Image

    tot = 0
    for dirpath, _dirnames, filenames in os.walk(root_dir):
        for fn in filenames:
            if fn[-4:] != ".png" or fn[0] == ".":
                continue
            img_pil = Image.open(os.path.join(dirpath, fn)).convert("RGB")
            if target_size is not None:
                w, h = img_pil.size
                if w > h:
                    img_pil = img_pil.resize((target_size, int(h * (target_size / float(w)))))
                else:
                    img_pil = img_pil.resize((int(w * (target_size / float(h))), target_size))
                out_path = os.path.join(dirpath, fn[:-4] + f"_{target_size}.jpg")
            else:
                out_path = os.path.join(dirpath, fn[:-4] + ".jpg")
            img_pil.save(out_path)
            tot += 1
            if log_freq and tot % log_freq == 0:
                log_fn(f"Converted {tot} images so far")
    return tot


def cmd_create_jpeg(args):
    tot = create_jpeg(args.root_dir, None if args.target_size <= 0 else args.target_size)
    print(f"converted {tot} png(s) under {args.root_dir}")


def cmd_dataloader(args):
    """Data-loading throughput smoke test (reference datasets/bedlam.py:428-447)."""
    ds = get_dataset(args.dataset, args.img_size, training=args.training)
    t0 = time.time()
    n = min(args.n, len(ds))
    for i in range(n):
        x, annot = ds[i]
        if i % 20 == 0:
            print(f"[{i}/{n}] {annot['imagename']} humans={len(annot['humans'])}")
            sys.stdout.flush()
    dt = time.time() - t0
    print(f"{n} samples in {dt:.1f}s = {n/dt:.2f} img/s")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["create_annots", "visualize", "dataloader", "create_jpeg"])
    p.add_argument("--dataset", default="ehf", choices=["bedlam", "ehf", "3dpw"])
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--training", type=int, default=0)
    p.add_argument("--device", default="cuda", help="visualize: where the GT bodies are posed")
    p.add_argument("--root_dir", default=".", help="create_jpeg: tree to walk")
    p.add_argument("--target_size", type=int, default=512,
                   help="create_jpeg: long-side target; <=0 keeps size")
    args = p.parse_args(argv)
    {"create_annots": cmd_create_annots, "visualize": cmd_visualize,
     "dataloader": cmd_dataloader, "create_jpeg": cmd_create_jpeg}[args.command](args)


if __name__ == "__main__":
    main()
