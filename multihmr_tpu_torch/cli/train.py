"""Training/eval CLI (``multihmr_tpu/cli/train.py``), the analogue of reference
train.py:484-591.

Usage:
    python -m multihmr_tpu_torch.cli.train --backbone dinov2_vitl14 --img_size 896 \\
        --tp_mode ring --n_devices 1 --batch_size 2 [--eval_only 1] [--device cuda]

BEDLAM training through ``Trainer.fit`` with Adam, per-epoch checkpoints and
the epoch-end evaluation over ``--valset`` (``bedlam``, ``ehf``, ``3dpw``).
The flags are the JAX CLI's, flag for flag, plus ``--device`` (default
``cuda``). ``--tp_mode ring`` runs the ViT's standard stream (K5 forward),
``heads`` the channels-major one (K1, K2); on one device neither shards
anything. ``--pretrained`` takes this port's own checkpoint (``ckpt_*.pt``
with its ``.json`` beside it), the JAX package's own (``ckpt_*.msgpack``,
flax, decoded without flax and loaded strictly) or a reference
``multiHMR_*.pt``, converted for the config the flags give.

3DPW evaluation reads its assets under ``$SMPLX_DIR`` (default ``models``),
in the reference's layout (``smplx/smplx2smpl.pkl``, ``smpl/...``) or flat:
``smplx2smpl.pkl`` (without it the valset is skipped), ``J_regressor_h36m.npy``
(the MPJPE metrics) and ``smpl/SMPL_{MALE,FEMALE}.pkl`` (else a synthetic
SMPL, with a warning).

Several devices (``--n_devices N``, ``--model_parallel``, ``--fsdp 1``): one
rank per device, launched by ``torchrun --nproc_per_node N`` (N must equal
``--n_devices``), on NCCL for ``--device cuda`` and gloo for ``cpu``::

    torchrun --nproc_per_node 4 -m multihmr_tpu_torch.cli.train ... \
        --n_devices 4 --model_parallel 2 --fsdp 1

Under ``torchrun`` the ranks form a (data, model) mesh (parallel/sharding.py)
whatever ``--n_devices`` is, one rank included; each rank loads every batch
and trains on its ``data`` slice; rank 0 prints, evaluates (on one device,
with the gathered weights) and writes the checkpoints, in the single-device
formats. The JAX CLI's checks hold: ``--n_devices`` divisible by
``--model_parallel``, ``--batch_size`` by the data axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from multihmr_tpu_torch.train.loss import LossWeights


def build_argparser():
    p = argparse.ArgumentParser()
    # model (reference train.py:549-571)
    p.add_argument("--backbone", type=str, default="dinov2_vitb14")
    p.add_argument("--img_size", type=int, default=336)
    p.add_argument("--xat_depth", type=int, default=2)
    p.add_argument("--xat_num_heads", type=int, default=8)
    p.add_argument("--person_center", type=str, default="head")
    p.add_argument("--num_betas", type=int, default=10)
    p.add_argument("--max_people", type=int, default=16)
    p.add_argument(
        "--remat", type=str, default="auto", choices=["auto", "0", "1"],
        help="rematerialize ViT activations in the backward pass. 'auto' "
        "(default) picks the fastest level whose estimated peak memory "
        "fits the card (train/memory.py); '0'/'1' force it off/on",
    )
    p.add_argument(
        "--remat_policy", type=str, default=None, choices=["block", "mlp"],
        help="'mlp' recomputes only the MLP's hidden state; 'block' the "
        "whole block, the flash-attention forward included. With --remat "
        "auto, a pinned policy restricts auto's choice to {off, that "
        "policy}; with --remat 1 the default is 'mlp'",
    )
    # data
    p.add_argument("--trainset", type=str, default="bedlam")
    p.add_argument(
        "--valset", type=str, nargs="+", default=["ehf"],
        choices=("bedlam", "ehf", "3dpw"),
        help="val dataset(s) evaluated each epoch",
    )
    p.add_argument(
        "--val_split", type=str, nargs="+", default=None,
        help="per-valset split (default: 'validation' for bedlam, 'test' "
        "otherwise — the reference defaults, train.py:555)",
    )
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iter_per_epoch", type=int, default=1000)
    p.add_argument("--n_epoch", type=int, default=100)
    p.add_argument(
        "--max_iter", type=int, default=0,
        help="when >0, run max_iter // iter_per_epoch epochs instead of "
        "--n_epoch (reference train.py:568,590)",
    )
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument(
        "--train_subsample", type=int, default=1,
        help="train-set subsampling stride (reference train.py:562)",
    )
    p.add_argument(
        "--num_workers", "-j", type=int, default=0,
        help="host data-loading worker threads (a bounded ordered thread map "
        "over the batches, data/prefetch.py); 0 = load in-process",
    )
    p.add_argument(
        "--extension", type=str, default="png", choices=("png", "jpg"),
        help="train-image extension; 'jpg' reads the create_jpeg siblings "
        "(reference train.py:576, datasets/bedlam.py:62-78)",
    )
    p.add_argument(
        "--res", type=int, default=None,
        help="resolution suffix of the jpg siblings (reference train.py:577)",
    )
    p.add_argument(
        "--val_subsample", type=int, nargs="+", default=None,
        help="per-valset subsampling stride for fast evaluation; default: "
        "--subsample for every valset",
    )
    p.add_argument(
        "--train_n", type=int, default=-1,
        help="truncate the train set to its first N images (reference "
        "train.py:536,553)",
    )
    p.add_argument(
        "--val_n", type=int, nargs="+", default=[-1],
        help="per-valset truncation to the first N images (reference "
        "train.py:504,556)",
    )
    p.add_argument(
        "--amp", type=int, default=1, choices=(0, 1),
        help="1 = bf16 compute in the backbone (the reference's fp16 "
        "autocast, train.py:569); 0 = full fp32 compute",
    )
    # eval knobs inside training (reference train.py:357,441,575,579-580)
    p.add_argument("--det_thresh", type=float, default=0.2)
    p.add_argument("--nms_kernel_size", type=int, default=3)
    p.add_argument(
        "--visu_to_save", type=int, default=0,
        help="eval triptychs [input | prediction | GT] for the first N images of each "
        "valset, under <logdir>/<name>/visu_<valset>",
    )
    p.add_argument(
        "--log_freq", type=int, default=100,
        help="progress-print period, in eval images and in train steps "
        "(reference train.py:320,432,567)",
    )
    # optim (reference train.py:514,570)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument(
        "--clip_grad", type=float, default=0.0,
        help="global grad-norm clip (0 = off, reference parity)",
    )
    # parallelism: one rank per device under torchrun
    p.add_argument(
        "--n_devices", type=int, default=0,
        help="devices to train on, one torchrun rank each (0 = the launch's ranks: "
        "WORLD_SIZE under torchrun, else 1)",
    )
    p.add_argument(
        "--model_parallel", type=int, default=1,
        help="size of the mesh 'model' axis: Megatron TP of the ViT (--tp_mode heads) "
        "or ring attention over sequence shards (ring)",
    )
    p.add_argument(
        "--tp_mode", type=str, default="heads", choices=("heads", "ring"),
        help="'heads': the ViT's channels-major stream (K1, K2); 'ring': "
        "its standard stream (K5). With --model_parallel > 1 'heads' shards "
        "the heads, 'ring' the sequence",
    )
    p.add_argument(
        "--fsdp", type=int, default=0,
        help="1 = shard the large params and their Adam moments over the data axis "
        "(FSDP2)",
    )
    # logging / ckpt
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--logdir", type=str, default="logs")
    p.add_argument("--ckptdir", type=str, default="ckpts")
    p.add_argument("--nb_max_ckpt", type=int, default=3)
    p.add_argument(
        "--pretrained", type=str, default=None,
        help="initial weights: a checkpoint this port wrote (ckpt_*.pt with its "
        ".json), one the JAX package wrote (ckpt_*.msgpack) or a reference "
        "multiHMR_*.pt",
    )
    p.add_argument(
        "--resume", type=int, default=0,
        help="resume from the latest full train state in ckptdir/name "
        "(weights, Adam state, epoch); starts fresh when none exists",
    )
    p.add_argument("--eval_only", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on ('cuda' or 'cpu')")
    # loss weights (reference loss.py:117-141)
    for f in dataclasses.fields(LossWeights):
        p.add_argument(f"--{f.name}", type=type(f.default), default=f.default)
    return p


def _mesh(args, device: torch.device):
    """(mesh or None, data-axis size, this rank's device). The JAX CLI's
    checks first (``cli/train.py:228-243``); then, under ``torchrun`` (or in
    a rank whose process group is up), the default process group and the
    (data, model) mesh; one process without a launcher trains on one
    device."""
    import torch.distributed as dist

    launched = dist.is_initialized() or "RANK" in os.environ
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    n_dev = args.n_devices or world
    if n_dev % args.model_parallel:
        raise ValueError(f"--n_devices {n_dev} is not divisible by --model_parallel "
                         f"{args.model_parallel}")
    data = n_dev // args.model_parallel
    if args.batch_size % data:
        raise ValueError(f"batch_size {args.batch_size} must divide over the data axis ({data})")
    if not launched:
        if n_dev > 1:
            raise ValueError(f"--n_devices {n_dev}: one rank per device, launch with "
                             f"torchrun --nproc_per_node {n_dev} -m multihmr_tpu_torch.cli.train")
        return None, 1, device
    if world != n_dev:
        raise ValueError(f"--n_devices {n_dev} but the launch has {world} ranks "
                         f"(torchrun --nproc_per_node {n_dev})")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        from multihmr_tpu_torch.parallel.launch import init_from_env

        init_from_env("nccl" if device.type == "cuda" else "gloo")
    from multihmr_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(n_dev, model_parallel=args.model_parallel, device_type=device.type)
    if dist.get_rank() == 0:
        print(f"mesh: data={data} x model={args.model_parallel} ({args.tp_mode}), "
              f"fsdp={bool(args.fsdp)}")
    return mesh, data, device


def _is_port_checkpoint(path: str) -> bool:
    """This port's own checkpoints have their ``.json`` beside them."""
    return path.endswith(".pt") and os.path.isfile(path[:-3] + ".json")


def _apply_mean_params(net, cfg, smplx_dir: str) -> None:
    """From-scratch training starts from the SMPL mean pose when
    ``smpl_mean_params.npz`` exists (reference model.py:440-477); without
    it HPH keeps its neutral identity-6d init."""
    from multihmr_tpu_torch.bodymodel.assets import load_mean_params

    path = os.path.join(smplx_dir, "smpl_mean_params.npz")
    if not os.path.exists(path):
        return
    mean = load_mean_params(path, nrot=cfg.nrot, num_betas=cfg.num_betas)
    head = net.x_attention_head
    with torch.no_grad():
        for param, key in ((head.init_body_pose, "pose"), (head.init_betas, "shape"),
                           (head.init_cam, "cam"), (head.init_expression, "expression")):
            param.copy_(torch.from_numpy(mean[key]))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.data.collate import collate_padded
    from multihmr_tpu_torch.data.prefetch import bounded_parallel_map
    from multihmr_tpu_torch.factory import build_model, load_body_model, smplx_asset, smplx_dir
    from multihmr_tpu_torch.io.checkpoint import load_checkpoint, load_jax_checkpoint
    from multihmr_tpu_torch.train.evaluate import (
        evaluate_dataset,
        make_smpl_gt_forward,
        make_smplx_gt_forward,
    )
    from multihmr_tpu_torch.train.memory import device_hbm_limit, resolve_remat_flags
    from multihmr_tpu_torch.train.trainer import Trainer
    from multihmr_tpu_torch.utils.logging import MetricsLogger

    device = torch.device(args.device)
    mesh, data_size, device = _mesh(args, device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if device.type == "cuda":  # the geometry runs in full fp32, as the JAX package's HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = ModelConfig(
        backbone=args.backbone,
        img_size=args.img_size,
        xat_depth=args.xat_depth,
        xat_num_heads=args.xat_num_heads,
        person_center=args.person_center,
        num_betas=args.num_betas,
        max_people=args.max_people,
        compute_dtype="bfloat16" if args.amp else "float32",
    )
    # the per-device batch: the activations one device holds
    remat, policy, report = resolve_remat_flags(
        args.remat, args.remat_policy, cfg, max(1, args.batch_size // data_size),
        hbm_limit_bytes=device_hbm_limit(device))
    if report is not None and lead:
        print(f"remat auto: estimates {report['estimates_gb']} GB vs "
              f"{report['budget_bytes'] / 1e9:.1f} GB budget -> "
              f"{'remat=' + policy if remat else 'no remat'}")
    cfg = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
    if smplx_asset() is None and lead:
        print("WARNING: SMPL-X assets not found — using the synthetic body model")
    jax_ckpt = args.pretrained and args.pretrained.endswith(".msgpack")
    reference = args.pretrained and not jax_ckpt and not _is_port_checkpoint(args.pretrained)
    # the JAX package's checkpoint is decoded and mapped before any work: a
    # corrupt or mismatched file raises before the model or a log exists
    state = load_jax_checkpoint(args.pretrained, cfg)[0] if jax_ckpt else None
    model = build_model(device=device, seed=0, cfg=cfg, tp_mode=args.tp_mode,
                        checkpoint=args.pretrained if reference else None, mesh=mesh)
    bm = model.body_model
    # GT targets run through an 11-beta neutral SMPL-X like the reference
    # (train.py:41-43, 99-110), independent of the model's num_betas.
    gt_bm = load_body_model(device, 11) if cfg.num_betas != 11 else bm

    if args.pretrained and not reference:
        if state is None:
            state, _ = load_checkpoint(args.pretrained)
        if mesh is None:
            model.net.load_state_dict(state, strict=True)
        else:
            from multihmr_tpu_torch.parallel.sharding import load_full_state_dict

            load_full_state_dict(model.net, state, mesh, model.tp_mode)
    elif not args.pretrained:
        _apply_mean_params(model.net, cfg, smplx_dir())

    logger = MetricsLogger(args.logdir, args.name) if lead else None
    weights = LossWeights(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(LossWeights)})

    # Per-valset knob broadcasting (reference train.py:498 asserts equal
    # lengths; a single value here broadcasts to every valset).
    valsets = list(args.valset)

    def _per_set(v, default):
        vals = [default] * len(valsets) if v is None else list(v)
        if len(vals) == 1 and len(valsets) > 1:
            vals = vals * len(valsets)
        if len(vals) != len(valsets):
            raise ValueError(f"need one value per valset {valsets}, got {vals}")
        return vals

    val_split = _per_set(args.val_split, None)
    val_n = _per_set(args.val_n, -1)
    val_sub = _per_set(args.val_subsample, args.subsample)

    def run_eval(model, epoch):
        all_res = {}
        for vi, vname in enumerate(valsets):
            gt_fwd, eval_kw = None, {}
            if vname == "ehf":
                from multihmr_tpu_torch.data.ehf import EHF

                split = val_split[vi] or "test"
                ds = EHF(img_size=cfg.img_size, split=split, n=val_n[vi], subsample=val_sub[vi])
            elif vname == "3dpw":
                from multihmr_tpu_torch.bodymodel.assets import (
                    load_j_regressor_h36m,
                    load_smpl_pkl,
                    load_smplx2smpl,
                    synthetic_body_model,
                )
                from multihmr_tpu_torch.bodymodel.core import BodyModel
                from multihmr_tpu_torch.data.threedpw import THREEDPW

                # 3DPW GT is gendered SMPL (6,890 vertices): PVE against
                # SMPL-X predictions needs the smplx2smpl regressor
                # (reference train.py:383-384), in the reference layout
                # (smplx/, smpl/) or flat under $SMPLX_DIR
                root = smplx_dir()
                find = lambda *c: next((p for p in c if os.path.isfile(p)), None)  # noqa: E731
                s2s = find(os.path.join(root, "smplx", "smplx2smpl.pkl"),
                           os.path.join(root, "smplx2smpl.pkl"))
                if s2s is None:
                    print(f"3dpw eval SKIPPED: smplx2smpl.pkl not found under {root} "
                          "(needed to map SMPL-X predictions onto the SMPL-topology GT, "
                          "reference train.py:44-45,383-384)")
                    continue
                eval_kw = {"smplx2smpl": load_smplx2smpl(s2s)}
                jr = find(os.path.join(root, "smpl", "J_regressor_h36m.npy"),
                          os.path.join(root, "J_regressor_h36m.npy"))
                if jr is not None:  # the MPJPE metrics (reference train.py:397-429)
                    eval_kw["J_regressor_h36m"] = load_j_regressor_h36m(jr)
                split = val_split[vi] or "test"
                ds = THREEDPW(img_size=cfg.img_size, split=split, n=val_n[vi],
                              subsample=val_sub[vi], smpl_dir=root)
                layers = {}
                for g in ("male", "female"):
                    path = os.path.join(root, "smpl", f"SMPL_{g.upper()}.pkl")
                    if os.path.isfile(path):
                        arrays = load_smpl_pkl(path)
                    else:  # runnable without the licensed pkls
                        print(f"WARNING: {path} not found — synthetic {g} SMPL for 3dpw GT")
                        arrays = synthetic_body_model(num_vertices=6890, num_joints=24,
                                                      num_extra=0, num_lmk=0)
                    layers[g] = BodyModel.from_arrays(arrays, device)
                gt_fwd = make_smpl_gt_forward(layers, capacity=cfg.max_people)
            else:  # "bedlam"
                from multihmr_tpu_torch.data.bedlam import BEDLAM

                split = val_split[vi] or "validation"
                ds = BEDLAM(split=split, training=False, img_size=cfg.img_size,
                            n=val_n[vi], subsample=val_sub[vi])
                # GT meshes from the stored SMPL-X params through the same
                # 11-beta neutral layer as training (reference train.py:41-43)
                gt_fwd = make_smplx_gt_forward(gt_bm, num_betas=11)
            res = evaluate_dataset(
                model, ds, det_thresh=args.det_thresh, nms_kernel_size=args.nms_kernel_size,
                gt_forward=gt_fwd, log_every=args.log_freq, visu_to_save=args.visu_to_save,
                visu_dir=os.path.join(args.logdir, args.name, f"visu_{vname}"),
                faces=model.body_model.faces.cpu().numpy() if args.visu_to_save > 0 else None,
                **eval_kw)
            # reference tag shape: {name}-{split}-{subsample}/{metric}
            # (train.py:477-479); scalars only — 'timings' is a nested dict
            logger.scalars({k: v for k, v in res.items() if isinstance(v, (int, float))},
                           epoch, prefix=f"{vname}-{split}-{val_sub[vi]}/")
            print(f"eval[{vname}-{split}] epoch {epoch}: {res}")
            all_res[vname] = res
        # .get: a valset can be skipped (3dpw without smplx2smpl)
        return all_res if len(valsets) > 1 else all_res.get(valsets[0])

    if args.eval_only:
        if mesh is None:
            run_eval(model, 0)
        else:  # rank 0 evaluates the gathered weights on one device
            from multihmr_tpu_torch.parallel.sharding import gather_state_dict

            full = gather_state_dict(model.net, mesh, model.tp_mode)
            if lead:
                twin = model.unsharded()
                twin.net.load_state_dict(full)
                run_eval(twin, 0)
            torch.distributed.barrier()
        if logger is not None:
            logger.close()
        return

    from multihmr_tpu_torch.data.bedlam import BEDLAM

    trainset = BEDLAM(
        split="training", training=True, img_size=cfg.img_size,
        n_iter=args.batch_size * args.iter_per_epoch, n=args.train_n,
        subsample=args.train_subsample, extension=args.extension, res=args.res,
    )

    def make_batch(start):
        samples = []
        for i in range(start, min(start + args.batch_size, len(trainset))):
            x, annot = trainset[i]
            samples.append({
                "image": x,
                "K": annot["K"],
                "humans": [{
                    "pose": np.concatenate(
                        [h["smplx_root_pose"], h["smplx_body_pose"],
                         h["smplx_left_hand_pose"], h["smplx_right_hand_pose"],
                         h["smplx_jaw_pose"]], 0),
                    "shape": h["smplx_shape"][:11],
                    "transl": h["smplx_transl"],
                } for h in annot["humans"]],
            })
        return collate_padded(samples, cfg.max_people)

    def data_iter():
        # --num_workers > 0: decode/resize/collate in a bounded ordered
        # thread map (reference train.py:538-546); 0 = in-process
        yield from bounded_parallel_map(make_batch, range(0, len(trainset), args.batch_size),
                                        num_workers=args.num_workers)

    optimizer = torch.optim.Adam(model.net.parameters(), lr=args.lr, eps=1e-8)  # optax.adam
    trainer = Trainer(
        model, optimizer, weights=weights,
        checkpoint_dir=os.path.join(args.ckptdir, args.name),
        nb_max_ckpt=args.nb_max_ckpt, gt_body_model=gt_bm, clip_grad=args.clip_grad,
        log_every_steps=args.log_freq, mesh=mesh, fsdp=bool(args.fsdp),
    )
    start_epoch = 0
    if args.resume:
        restored = trainer.restore()
        if restored is None:
            trainer.log_fn("--resume: no saved train state found — starting fresh")
        else:
            start_epoch = restored
            trainer.log_fn(f"--resume: restored epoch {start_epoch - 1}, "
                           f"continuing at epoch {start_epoch}")
    # --max_iter caps total optimizer steps via the epoch count
    # (reference train.py:590: max_epochs = max_iter // n_iters_per_epoch)
    epochs = args.max_iter // args.iter_per_epoch if args.max_iter > 0 else args.n_epoch
    trainer.fit(data_iter, epochs=epochs, eval_fn=run_eval, start_epoch=start_epoch)
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():  # the torchrun launch's group
        torch.distributed.destroy_process_group()
