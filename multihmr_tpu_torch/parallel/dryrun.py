"""Multi-rank dryrun on the CPU (``multihmr_tpu/parallel/dryrun.py``): the
sharded train step and the sharded forwards of every mesh path, at toy
sizes, on ``n`` spawned gloo ranks, each held to the same computation on one
device.

    python -c "from multihmr_tpu_torch.parallel.dryrun import main; main(8)"

On a (data = n/2, model = 2) mesh:

  * one Megatron-TP + FSDP train step (bf16, remat on, the FSDP threshold
    lowered so that the toy parameters shard) has a finite loss, and at
    least one Adam moment is sharded;
  * the ring (sequence-parallel) forward with the stepped weights equals
    the single-device forward of the same (standard) stream within 5e-3;
  * the Anny family with TP equals its single-device forward within 5e-3;
  * the ViT-L head count (16) at model 2 and 4 equals it within 5e-3.

The configurations are the JAX dryrun's, DINOv2's LayerScale 1e-5 included:
in bf16 the blocks then hardly move the stream, so these are checks of the
plumbing (shapes, shards, collectives, a finite sharded step). The numbers
of every mesh path are held to one device, and to the JAX package's mesh,
in fp32 with LayerScale moved by tests/test_torch_parallel.py and
tests/test_torch_ring_attention.py; in bf16 with random weights a ulp of
noise in the scores reorders the K detections, whose meshes lie tens of
metres apart.

Every rank checks its own batch slice; a rank that fails fails the run.
Rank 0 prints one ``dryrun_multichip OK: ...`` line with the JAX line's
fields.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 5e-3  # bf16 compute, collectives in another summation order


def _max_delta(a, b, label):
    a, b = a.double(), b.double()
    if not torch.isfinite(a).all():
        raise AssertionError(f"non-finite {label} output")
    d = float((a - b).abs().max()) if a.numel() else 0.0
    if d > TOL:
        raise AssertionError(f"{label}: mesh forward != replicated (max|d|={d:.3e})")
    return d


def _rank(rank: int, n: int) -> dict:
    from torch.distributed.tensor import DTensor

    from multihmr_tpu_torch.bodymodel.anny import NUM_BONES, AnnyModel, synthetic_anny_model
    from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.config import ModelConfig, ViTConfig
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.models.multihmr_anny import AnnyConfig, MultiHMRAnny, MultiHMRAnnyNet
    from multihmr_tpu_torch.parallel import sharding
    from multihmr_tpu_torch.train.trainer import BATCH_KEYS, Trainer, to_device

    # the JAX dryrun's toy ViT: 4 heads, divisible by the model axis
    VIT = ViTConfig(embed_dim=64, depth=2, num_heads=4)
    model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = sharding.make_mesh(n, model_parallel, device_type="cpu")
    data = n // model_parallel

    def on_mesh(net_cls, cfg, full, m, tp_mode="heads"):
        net = net_cls(cfg, tp_mode=tp_mode, mesh=m)
        net.load_state_dict(sharding.shard_state_dict(full, m, tp_mode))
        return net

    def one_device(net_cls, cfg, full, tp_mode="heads"):
        net = net_cls(cfg, tp_mode=tp_mode)
        net.load_state_dict(full)
        return net

    def my_slice(t, m):
        return sharding.shard_batch({"t": t}, m)["t"]

    cfg = ModelConfig(backbone="dinov2_vits14", img_size=112, max_people=4, person_center="head",
                      compute_dtype="bfloat16", remat=True,
                      vit_override=VIT)
    bm = BodyModel.from_arrays(synthetic_body_model(num_vertices=64, num_joints=55,
                                                    num_extra=21, num_lmk=51), "cpu")
    full = MultiHMRNet(cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    model = MultiHMR(cfg, bm, net=on_mesh(MultiHMRNet, cfg, full, mesh), mesh=mesh)

    B, Kh, S = data, cfg.max_people, cfg.img_size
    rng = np.random.default_rng(0)  # the same global batch on every rank
    Kmat = np.asarray([[100.0, 0, S / 2], [0, 100.0, S / 2], [0, 0, 1]], np.float32)
    batch = {
        "image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
        "K": np.broadcast_to(Kmat, (B, 3, 3)).copy(),
        "gt_pose": rng.normal(scale=0.2, size=(B, Kh, 53, 3)).astype(np.float32),
        "gt_shape": rng.normal(size=(B, Kh, 10)).astype(np.float32),
        "gt_transl": (rng.normal(scale=0.3, size=(B, Kh, 3)) + [0, 0, 3.0]).astype(np.float32),
        "gt_valid": (rng.uniform(size=(B, Kh)) > 0.4).astype(np.float32),
    }
    # TP over 'model' + FSDP over 'data' (the threshold lowered so that the
    # toy parameters shard; real configurations keep the default)
    trainer = Trainer(model, torch.optim.Adam(model.net.parameters(), lr=5e-6, eps=1e-8),
                      mesh=mesh, fsdp=True, fsdp_min_size=1024)
    local = sharding.shard_batch({k: batch[k] for k in BATCH_KEYS}, mesh)
    terms = trainer.train_step(to_device(local, "cpu"), 0)
    total = float(terms["total"])
    if not np.isfinite(total):
        raise AssertionError(f"non-finite loss: {terms}")
    n_sharded = sum(isinstance(st.get("exp_avg"), DTensor)
                    for st in trainer.optimizer.state.values())
    if not n_sharded:
        raise AssertionError("FSDP: no Adam moment ended up sharded")

    # sequence-parallel (ring) forward with the stepped weights
    stepped = trainer.full_state()
    x = torch.from_numpy(batch["image"])
    K = torch.from_numpy(batch["K"])
    xs, Ks = my_slice(x, mesh), my_slice(K, mesh)
    with torch.no_grad():
        sp = MultiHMR(cfg, bm, net=on_mesh(MultiHMRNet, cfg, stepped, mesh, "ring"), mesh=mesh)
        ref = MultiHMR(cfg, bm, net=one_device(MultiHMRNet, cfg, stepped, "ring"))
        d_sp = _max_delta(sp.forward(xs, Ks)["v3d"], ref.forward(xs, Ks)["v3d"], "SP(ring)")

        # the Anny family with TP
        acfg = AnnyConfig(img_size=112, xat_dim=64, xat_depth=2, xat_heads=4, xat_dim_head=16,
                          xat_mlp_dim=128, max_people=4, compute_dtype="bfloat16",
                          vit_override=VIT)
        abm = AnnyModel.from_arrays(synthetic_anny_model(num_vertices=64, num_bones=NUM_BONES),
                                    "cpu")
        afull = MultiHMRAnnyNet(acfg).init_weights(torch.Generator().manual_seed(1)).state_dict()
        anny = MultiHMRAnny(acfg, abm, net=on_mesh(MultiHMRAnnyNet, acfg, afull, mesh), mesh=mesh)
        anny_ref = MultiHMRAnny(acfg, abm, net=one_device(MultiHMRAnnyNet, acfg, afull))
        d_anny = _max_delta(anny.forward(xs)["v3d"], anny_ref.forward(xs)["v3d"], "Anny TP")

        # the ViT-L head count (16) over model axes 2 and 4
        gcfg = ModelConfig(backbone="dinov2_vitl14", img_size=224, max_people=4,
                           person_center="head", compute_dtype="bfloat16",
                           vit_override=ViTConfig(embed_dim=256, depth=2, num_heads=16))
        gfull = MultiHMRNet(gcfg).init_weights(torch.Generator().manual_seed(2)).state_dict()
        gref = MultiHMR(gcfg, bm, net=one_device(MultiHMRNet, gcfg, gfull))
        gx = torch.from_numpy(rng.normal(size=(n, 224, 224, 3)).astype(np.float32))
        gK = torch.from_numpy(np.broadcast_to(Kmat, (n, 3, 3)).copy())
        d_g = {}
        for mp in (2, 4):
            if n % mp:
                continue
            gmesh = sharding.make_mesh(n, mp, device_type="cpu")
            gB = n // mp
            gxs, gKs = my_slice(gx[:gB], gmesh), my_slice(gK[:gB], gmesh)
            gmodel = MultiHMR(gcfg, bm, net=on_mesh(MultiHMRNet, gcfg, gfull, gmesh), mesh=gmesh)
            d_g[mp] = _max_delta(gmodel.forward(gxs, gKs)["v3d"], gref.forward(gxs, gKs)["v3d"],
                                 f"heads16/mp{mp}")
    return {"data": data, "model": model_parallel, "total": total, "n_sharded": n_sharded,
            "d_sp": d_sp, "d_anny": d_anny, "d_g": d_g}


def main(n_devices: int = 8) -> None:
    """Spawn ``n_devices`` gloo CPU ranks and run the dryrun; print its line."""
    from multihmr_tpu_torch.parallel.launch import run_ranks

    res = run_ranks(_rank, n_devices)
    r = res[0]
    worst = lambda key: max(x[key] for x in res)  # noqa: E731
    g_str = ", ".join(f"mp{mp} {max(x['d_g'][mp] for x in res):.1e}" for mp in r["d_g"])
    print(
        f"dryrun_multichip OK: {n_devices} devices "
        f"(data={r['data']}, model={r['model']}), TP+FSDP train-step "
        f"loss={r['total']:.4f} ({r['n_sharded']} sharded moment leaves), "
        f"SP(ring) = replicated (max|d| {worst('d_sp'):.1e}), "
        f"Anny TP = replicated ({worst('d_anny'):.1e}), "
        f"heads=16 TP = replicated ({g_str})"
    )


if __name__ == "__main__":
    import sys

    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
