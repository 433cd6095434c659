"""The port's multi-device execution (``multihmr_tpu_torch/parallel``) against
the JAX package's mesh path: the cases of tests/test_parallel.py.

The port's side runs as one world of 4 spawned gloo ranks on a (data 2,
model 2) mesh (tests/torch_parallel_ranks.py, which imports no jax), while
the JAX side runs here on 4 of conftest's 8 virtual CPU devices at the same
mesh shape. Both get the same weights: the tiny configuration
(tests/test_checkpoint.py's, 56 px, ViT 32 wide, 2 deep, 2 heads, so one
head per rank) from a reference-layout state dict, tempered and at
LayerScale 0.5 so that the blocks move the stream, through the JAX
converter and then ``params_from_jax``; every rank cuts its shards with
``shard_state_dict``. Everything runs in fp32.

Tolerances: the JAX tests' own where they apply (TP v3d 5e-4 abs, scores
1e-5 abs, train-step loss rtol 1e-5); against the port on one device, the
forward 5e-5 abs (sums over other partitions) and each gradient 1e-4 of its
largest magnitude (the same, through a backward); checkpoints bitwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import optax

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.config import ModelConfig as JModelConfig, ViTConfig as JViTConfig
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.parallel import batch_sharding, make_mesh as jmake_mesh, param_shardings
from multihmr_tpu.parallel import shard_params
from multihmr_tpu.parallel.infer import folder_inference as jfolder_inference
from multihmr_tpu.train.trainer import make_train_step
from multihmr_tpu_torch.io import checkpoint as ckpt
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.parallel import sharding
from multihmr_tpu_torch.parallel.launch import Ranks
from tests import torch_parallel_ranks as ranks
from tests.test_checkpoint import make_reference_state_dict
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

CFG = JModelConfig(img_size=56, max_people=4, person_center="head", compute_dtype="float32",
                   vit_override=JViTConfig(embed_dim=32, depth=2, num_heads=2,
                                           layerscale_init=0.5))
FWD_V3D, FWD_SCORES = 5e-4, 1e-5  # the JAX test's
LOSS_RTOL = 1e-5
ONE_DEVICE_FWD = 5e-5
GRAD_TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _weights():
    """(JAX params, the port's full state dict) of the same tempered weights
    (shared by the tests, which do not change them)."""
    sd = make_reference_state_dict(CFG, np.random.default_rng(0))
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim >= 2:
            sd[k] = (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
        if k.endswith("gamma"):
            sd[k] = np.full_like(v, 0.5)
    params = jax.device_get(convert_torch_checkpoint({"model_state_dict": sd}, CFG))
    return params, params_from_jax(params, CFG)


def _batch():
    """The JAX test's batch at B = 4 with unequal valid counts over the two
    data ranks (7 slots on rank 0's half, 2 on rank 1's)."""
    rng = np.random.default_rng(7)
    B, Kh = 4, CFG.max_people
    return {
        "image": rng.normal(size=(B, 56, 56, 3)).astype(np.float32),
        "K": np.broadcast_to(np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32),
                             (B, 3, 3)).copy(),
        "gt_pose": rng.normal(scale=0.2, size=(B, Kh, 53, 3)).astype(np.float32),
        "gt_shape": rng.normal(size=(B, Kh, 10)).astype(np.float32),
        "gt_transl": (rng.normal(scale=0.3, size=(B, Kh, 3)) + [0, 0, 3.0]).astype(np.float32),
        "gt_valid": np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0], [0, 1, 0, 0]],
                             np.float32),
    }


def _jax_side(params, batch):
    """The JAX package's mesh path at (data 2, model 2)."""
    jbm = jsynthetic(**ranks.BM_ARGS)
    mesh = jmake_mesh(4, model_parallel=2)
    sp = shard_params(mesh, params)
    xb = jax.device_put(batch["image"], batch_sharding(mesh))
    Kb = jax.device_put(batch["K"], batch_sharding(mesh))
    out = {}
    for tp_mode in ("heads", "ring"):
        m = JMultiHMR(CFG, jbm, mesh=mesh, tp_mode=tp_mode)
        with mesh:
            o = jax.jit(lambda p, x, K: m.forward(p, x, K))(sp, xb, Kb)
        out[f"fwd_{tp_mode}"] = {k: np.asarray(o[k], np.float64) for k in ("v3d", "scores")}

    optimizer = optax.adam(ranks.LR)
    tp_model = JMultiHMR(CFG, jbm, mesh=mesh, tp_mode="heads")
    jbatch = jax.device_put(batch, batch_sharding(mesh, batch))

    def one_step(p):
        with mesh:
            opt_state = jax.jit(optimizer.init)(p)
            _, _, terms = make_train_step(tp_model, optimizer, donate=False)(p, opt_state,
                                                                              jbatch, 0)
            return {k: float(v) for k, v in terms.items()}

    # TP + FSDP; tests/test_parallel.py holds the JAX TP step (and one device)
    # to the same loss at the same rtol, so the port's TP step is held to it too
    out["fsdp_terms"] = one_step(jax.device_put(
        params, param_shardings(mesh, params, fsdp=True, fsdp_min_size=64)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port ranks' results, JAX results, the port on one device, paths)."""
    d = tmp_path_factory.mktemp("parallel")
    params, state = _weights()
    batch = _batch()
    # the port on one device: forwards, one train step, and its train state
    single = {f"fwd_{m}": ranks._forward(state, batch["image"], batch["K"], None, m)
              for m in ("heads", "ring")}
    trainer, single["terms"], single["grads"] = ranks.train_once(state, batch)
    _, _, single["clip_grads"] = ranks.train_once(state, batch, clip_grad=ranks.CLIP)
    paths = {"single_ckpt": str(d / "single"), "mesh_ckpt": str(d / "mesh")}
    ckpt.save_train_state(paths["single_ckpt"], 0, trainer.full_state(),
                          trainer._optimizer_state(), 3)
    torch.save({"state": state, "batch": batch, "grads": single["grads"],
                "clip_grads": single["clip_grads"], **paths}, d / "inputs.pt")
    started = Ranks(ranks.parallel_world, 4, (str(d / "inputs.pt"),))
    jax_out = _jax_side(params, batch)  # meanwhile
    return started.results(), jax_out, single, paths


def _assembled(res, key):
    """A per-data-rank output put back together in batch order (model rank 0
    of each data rank; every model rank holds the same)."""
    by_data = {r["coords"][0]: r[key] for r in res if r["coords"][1] == 0}
    return {k: np.concatenate([by_data[i][k] for i in sorted(by_data)]) for k in by_data[0]}


def test_rank_world_available(world):
    res = world[0]
    assert [r["world"] for r in res] == [(4, "gloo")] * 4
    assert sorted(r["coords"] for r in res) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_make_mesh_shapes(world):
    for r in world[0]:
        assert r["shapes"] == [{"data": 2, "model": 2}, {"data": 4, "model": 1}]


def test_param_sharding_rules():
    """The JAX rules' leaves are the port's TP leaves; the qkv split follows
    the heads; shards put back together bitwise; ring mode replicates."""
    params, state = _weights()
    jsh = param_shardings(jmake_mesh(4, model_parallel=2), params)
    jax_tp = set()
    for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]:
        if any(a is not None for a in s.spec):
            keys = [str(getattr(p, "key", p)) for p in path]
            jax_tp.add(f"{keys[-2]}.{ {'kernel': 'weight'}.get(keys[-1], keys[-1]) }")
    port_tp = {".".join(k.split(".")[-2:]) for k in state if sharding.tp_rule(k) is not None}
    assert port_tp == jax_tp == {"qkv.weight", "qkv.bias", "proj.weight", "fc1.weight",
                                 "fc1.bias", "fc2.weight"}
    assert sharding.tp_rule("backbone.blocks.0.attn.proj.bias") is None
    assert sharding.tp_rule("backbone.pos_embed") is None

    D, H, P = 32, 4, 2  # 4 heads of 8 over 2 ranks: rank 1 keeps heads 2 and 3
    rows = torch.arange(3 * D, dtype=torch.float32)[:, None].expand(3 * D, D)
    local = sharding.shard_tensor("backbone.blocks.0.attn.qkv.weight", rows, 1, P)
    want = [t * D + h * (D // H) + j for t in range(3) for h in (2, 3) for j in range(D // H)]
    assert local[:, 0].tolist() == want
    for k, v in state.items():
        shards = [sharding.shard_tensor(k, v, r, P) for r in range(P)]
        assert torch.equal(sharding.unshard_tensors(k, shards), v), k
    # the port-only SwiGLU FFN (no JAX rule): w12's rows by matching halves
    # (rank 1 of 2 keeps rows 2-3 of x1's half and 6-7 of x2's), w3 by columns
    w12 = torch.arange(8, dtype=torch.float32)[:, None].expand(8, D)
    name = "backbone.blocks.0.mlp.w12.weight"
    assert sharding.shard_tensor(name, w12, 1, P)[:, 0].tolist() == [2, 3, 6, 7]
    assert torch.equal(sharding.unshard_tensors(
        name, [sharding.shard_tensor(name, w12, r, P) for r in range(P)]), w12)
    assert (sharding.tp_rule("backbone.blocks.0.mlp.w12.bias"),
            sharding.tp_rule("backbone.blocks.0.mlp.w3.weight"),
            sharding.tp_rule("backbone.blocks.0.mlp.w3.bias")) == ("halves", 1, None)

    class Ring:  # a mesh stand-in: shard_state_dict reads nothing of it in ring mode
        pass
    assert all(a is b for a, b in zip(sharding.shard_state_dict(state, Ring(), "ring").values(),
                                      state.values()))


@pytest.mark.parametrize("tp_mode", ["heads", "ring"])
def test_tp_sharded_forward_matches_jax(world, tp_mode):
    """The heads-TP and ring forwards equal the JAX mesh forward (the JAX
    test's tolerances) and the port on one device."""
    res, jax_out, single, _ = world
    got = _assembled(res, f"fwd_{tp_mode}")
    want = jax_out[f"fwd_{tp_mode}"]
    np.testing.assert_allclose(got["v3d"], want["v3d"], atol=FWD_V3D)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=FWD_SCORES)
    for k in ("v3d", "scores"):
        np.testing.assert_allclose(got[k], single[f"fwd_{tp_mode}"][k], atol=ONE_DEVICE_FWD)


def test_tp_train_step_matches_jax(world):
    """One heads-TP Adam step: the loss equals the JAX mesh step's (TP +
    FSDP, which tests/test_parallel.py holds to the TP-only and the
    single-device loss) and the gradients the port's single-device step's."""
    res, jax_out, single, _ = world
    for r in res:
        assert r["tp_terms"]["finite"] == 1.0
        np.testing.assert_allclose(r["tp_terms"]["total"], jax_out["fsdp_terms"]["total"],
                                   rtol=LOSS_RTOL)
        assert set(r["tp_grads"]) == set(single["grads"])
        for n, e in r["tp_grads"].items():
            assert e <= GRAD_TOL, (n, e)


def test_fsdp_train_step_matches_jax(world):
    """TP + FSDP with unequal valid counts on the two data ranks: the loss
    equals the JAX FSDP step's, and the gradients the single-device step's.
    A per-rank mean (instead of each rank's sum over the whole batch's
    counts) would miss both."""
    res, jax_out, single, _ = world
    valid = {r["coords"][0]: r["valid_here"] for r in res}
    assert valid[0] != valid[1], valid
    for r in res:
        np.testing.assert_allclose(r["fsdp_terms"]["total"], jax_out["fsdp_terms"]["total"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["fsdp_terms"]["total"], single["terms"]["total"],
                                   rtol=LOSS_RTOL)
        assert set(r["fsdp_grads"]) == set(single["grads"])
        for n, e in r["fsdp_grads"].items():
            assert e <= GRAD_TOL, (n, e)


def test_fsdp_clip_grad_takes_the_global_norm(world):
    """``clip_grad`` under TP + FSDP scales by the whole model's gradient
    norm (each TP shard once over 'model', each FSDP shard once over
    'data'), as torch.nn.utils.clip_grad_norm_ on one device does."""
    res, _, single, _ = world
    norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in single["grads"].values())))
    assert norm > 10 * ranks.CLIP  # the step clips
    for r in res:
        assert set(r["clip_grads"]) == set(single["clip_grads"])
        for n, e in r["clip_grads"].items():
            assert e <= GRAD_TOL, (n, e)


def test_fsdp_shards_large_params_and_opt_state(world):
    """fsdp shards each leaf of fsdp_min_size (64) elements or more over
    'data' on dim 0 (on top of the TP shard), leaves the small ones
    replicated, and the Adam moments sit sharded like their parameters."""
    res, _, single, _ = world
    names = list(single["grads"])
    for r in res:
        assert r["dtensor_params"] and set(r["dtensor_params"]).isdisjoint(r["small_params"])
        assert set(r["dtensor_params"]) | set(r["small_params"]) == set(names)
        m = r["moment"]
        assert m["dtensor"] and m["step_plain"]
        assert m["full"] == (3 * 32 // 2, 32)  # the rank's TP shard: its head's q, k, v rows
        assert m["local"] == (m["full"][0] // 2, m["full"][1])  # and FSDP's half of it
    full_bytes = sum(2 * 4 * g.numel() for g in single["grads"].values())
    assert all(r["moment_bytes"] < full_bytes / 2 for r in res)


def test_checkpoint_resumes_across_device_counts(world):
    """Rank 0 writes the gathered full state in the single-device format: it
    restores bitwise on one device; a single-device state restores bitwise
    into every rank's shards."""
    res, _, _, paths = world
    trainer = ranks.make_trainer(_weights()[1], ckpt_dir=paths["mesh_ckpt"])
    assert trainer.restore() == 1
    assert ranks.digest(trainer.full_state()) == res[0]["mesh_state"]
    moments = trainer._optimizer_state()["state"]
    assert ranks.digest({i: s["exp_avg_sq"] for i, s in moments.items()}) == \
        res[0]["mesh_moments"]

    saved = ckpt.latest_train_state(paths["single_ckpt"])
    for r in res:
        assert r["restored_state"] == ranks.digest(saved["model"])
        assert r["restored_moments"] == ranks.digest(
            {i: s["exp_avg_sq"] for i, s in saved["optimizer"]["state"].items()})
        assert set(r["restored_step"]) == {1.0}


def test_folder_inference_dp():
    """Data parallelism in one process over [cpu, cpu]: five images at batch
    4 (the last batch padded), each image's persons equal to the JAX
    package's folder_inference on a 4-device data mesh and to the port's
    forward of that image alone."""
    params, state = _weights()
    model = ranks.port_model(state)
    rng = np.random.default_rng(0)
    images = [rng.normal(size=(56, 56, 3)).astype(np.float32) for _ in range(5)]
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)
    from multihmr_tpu_torch.parallel.infer import folder_inference

    got = folder_inference(model, images, K, det_thresh=0.1, batch_size=4, mesh=["cpu", "cpu"])
    jm = JMultiHMR(CFG, jsynthetic(**ranks.BM_ARGS))
    want = jfolder_inference(jm, params, images, K, det_thresh=0.1, batch_size=4,
                             mesh=jmake_mesh(4, model_parallel=1))
    assert len(got) == len(want) == 5
    assert sum(len(p) for p in got) > 0
    with torch.no_grad():
        alone = model.extract_persons(model.forward(torch.from_numpy(images[4][None]),
                                                    torch.from_numpy(K[None]), det_thresh=0.1))
    assert len(alone[0]) == len(got[4])
    for a, b in zip(got[4], alone[0]):
        np.testing.assert_allclose(a["v3d"], b["v3d"], atol=ONE_DEVICE_FWD)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a["v3d"], np.asarray(b["v3d"]), atol=FWD_V3D)


def _one_batch_at_a_time(model, images, K, batch_size, mesh, fields):
    """folder_inference's batches, each read back before the next is
    stacked: the loop without its pipeline."""
    from multihmr_tpu_torch.parallel.infer import DataParallel, persons_in_order

    dp = DataParallel(model, mesh or ["cpu"])
    out = []
    with torch.inference_mode():
        for start in range(0, len(images), batch_size):
            idxs = list(range(start, min(start + batch_size, len(images))))
            idxs_pad = idxs + [idxs[-1]] * (batch_size - len(idxs))
            xb = np.stack([images[i] for i in idxs_pad])
            Kb = np.stack([K] * batch_size)
            out += persons_in_order(dp.start_persons(xb, Kb, fields=fields,
                                                     det_thresh=0.1))[:len(idxs)]
    return out


@pytest.mark.parametrize("n_images,batch_size,mesh,fields", [
    (6, 2, None, None),              # the batch size divides the count
    (5, 2, None, None),              # a padded last batch
    (3, 3, None, None),              # a single batch
    (5, 4, ["cpu", "cpu"], None),    # two replicas, padded
    (5, 2, None, ["loc", "v3d"]),    # a restricted readback
])
def test_folder_inference_pipelined_bitwise(n_images, batch_size, mesh, fields):
    """folder_inference, which enqueues each batch before it reads the
    previous one back, gives bitwise the persons of the same batches read
    back one at a time, in image order; PIPELINE counts every batch, and
    all but the first of a call as run ahead."""
    from multihmr_tpu_torch.parallel import infer

    model = ranks.port_model(_weights()[1])
    rng = np.random.default_rng(n_images)
    images = [rng.normal(size=(56, 56, 3)).astype(np.float32) for _ in range(n_images)]
    K = np.array([[100.0, 0, 28], [0, 100, 28], [0, 0, 1]], np.float32)
    infer.reset_pipeline()
    got = infer.folder_inference(model, images, K, det_thresh=0.1, batch_size=batch_size,
                                 mesh=mesh, fields=fields)
    batches = -(-n_images // batch_size)
    assert infer.PIPELINE == {"batches": batches, "ahead": batches - 1}
    want = _one_batch_at_a_time(model, images, K, batch_size, mesh, fields)
    assert len(got) == len(want) == n_images
    assert sum(len(p) for p in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.keys() == b.keys() == set(fields or a.keys())
            for k in a:  # bytes: a slot's j2d may hold NaN (a joint at depth 0)
                assert (a[k].dtype, a[k].shape, a[k].tobytes()) == (
                    b[k].dtype, b[k].shape, b[k].tobytes()), k


def test_dryrun_multichip_8(capsys):
    """parallel/dryrun.py on 8 spawned gloo ranks prints its OK line."""
    from multihmr_tpu_torch.parallel.dryrun import main

    main(8)
    line = capsys.readouterr().out
    assert "dryrun_multichip OK: 8 devices (data=4, model=2), TP+FSDP train-step" in line
    assert "SP(ring) = replicated" in line and "heads=16 TP = replicated (mp2" in line
