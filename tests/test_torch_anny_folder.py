"""The Anny family (``MultiHMRAnny``) on the port's batched folder path, on
the CPU at a tiny size (a 2-block, 32-wide ViT at 112 px, a 2-deep 64-wide
decoder, the 163-bone synthetic asset at 64 vertices), with the benchmark's
seeded weights (``portbench/weights_anny.py``):

* ``folder_inference`` gives bitwise the persons of one forward and
  ``extract_persons`` a batch, in image order, for full and short last
  batches; ``fields`` restricts what is read back;
* ``replica`` is the model itself on its own device, and elsewhere a copy
  that gives bitwise the same persons;
* the spans come once a batch in the order ``vit``, ``head`` holding
  ``decoder``, ``body`` holding ``fk``; ``FK`` counts 163 compositions a
  call (55 for an SMPL-X skeleton);
* the forward kinematics replay a CUDA graph only on a card under
  ``inference_mode`` outside a tracer or a capture: everywhere else the
  plain loop runs, bitwise as before, and gradients flow through it;
* the port against the plain reference ``portbench/reference/anny.py`` in
  fp32: the same cells, and every field within a tolerance that a bf16
  decoder breaks.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.bodymodel import core
from multihmr_tpu_torch.bodymodel.anny import AnnyModel
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.config import ViTConfig
from multihmr_tpu_torch.models.multihmr_anny import AnnyConfig, MultiHMRAnny, MultiHMRAnnyNet
from multihmr_tpu_torch.parallel import infer
from multihmr_tpu_torch.utils import profiling
from portbench import harness, inputs, weights_anny
from portbench.reference.anny import AnnyReference
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

S, SEED = 112, 5
CFG = AnnyConfig(img_size=S, xat_dim=64, xat_depth=2, xat_heads=4, xat_dim_head=16,
                 xat_mlp_dim=128, max_people=4, compute_dtype="float32",
                 vit_override=ViTConfig(embed_dim=32, depth=2, num_heads=2))
K = inputs.camera_K(S, 60)

# |port - reference| on the CPU in fp32 at most these, per field. Both sides
# compute in fp32 with the same operations in other orders, so they part by
# a few ulps of each field's scale (measured: loc 4.8e-7 px on ~100 px, the
# metric fields 4.8e-7 m on ~3 m, rotations 2.4e-7, phenotypes 6e-8, fov
# 2.4e-7 rad); a bf16 decoder parts by 1e-4 to 2e-3 in every field it feeds.
TOLS = {
    "loc": 1e-4,  # px: 200 ulps of a ~100 px coordinate, 20 x below a bf16 decoder's 2e-3
    "transl": 1e-5,  # m: 40 ulps at 3 m; a bf16 decoder's distance parts by 7e-4
    "rotmat": 1e-5,  # unit entries: 80 ulps; bf16 decoder 1.2e-4
    "shape": 1e-5,  # sigmoid phenotypes near 0.5: 160 ulps; bf16 decoder 1e-4
    "v3d": 1e-5,  # m, as transl; bf16 decoder 7.5e-4
    "j3d": 1e-5,  # m, as transl; bf16 decoder 7.6e-4
    "fov": 1e-5,  # rad: from the class token alone, no decoder in its way
}


def tiny_config() -> dict:
    """The configuration file's dict at the tiny size (the asset's other
    sizes, the placement and the gains as committed)."""
    c = harness.load_json(harness.ROOT / "configs" / "multiHMR_672_L_anny.json")
    c.update(name="tiny_anny", img_size=S, embed_dim=32, depth=2, num_heads=2, xat_dim=64,
             xat_depth=2, xat_heads=4, xat_dim_head=16, xat_mlp_dim=128, max_people=4,
             compute_dtype="float32", body_model=dict(c["body_model"], num_vertices=64))
    return c


@pytest.fixture(scope="module")
def tiny():
    c = tiny_config()
    net = weights_anny.load(MultiHMRAnnyNet, CFG, c, SEED, "cpu").eval()
    asset = weights_anny.asset(c["body_model"], SEED)
    model = MultiHMRAnny(CFG, AnnyModel.from_arrays(asset, "cpu"), net=net)
    frames = inputs.frames([[64, 48], [96, 160], [112, 112]], 2, SEED, "cpu")
    images = [inputs.normalize(inputs.contain_pad(f, S)) for f in frames]
    with torch.device("meta"):
        shapes, norms = weights_anny.net_layout(MultiHMRAnnyNet(CFG))
    ref = AnnyReference(c, weights_anny.draw(shapes, norms, c, SEED, "cpu"), asset, "cpu")
    return dataclasses.make_dataclass("Tiny", ["model", "images", "ref"])(model, images, ref)


def _forward(model, x):
    Kb = torch.from_numpy(np.stack([K] * len(x)))
    with torch.inference_mode():
        return model.forward(torch.from_numpy(np.stack(x)), Kb)


def _one_batch_at_a_time(model, images, batch_size, fields=None):
    out = []
    for start in range(0, len(images), batch_size):
        idxs = list(range(start, min(start + batch_size, len(images))))
        idxs += [idxs[-1]] * (batch_size - len(idxs))
        persons = model.extract_persons(_forward(model, [images[i] for i in idxs]), fields)
        out += persons[:min(batch_size, len(images) - start)]
    return out


def _assert_bitwise(got, want, fields=None):
    assert len(got) == len(want)
    assert sum(len(p) for p in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.keys() == b.keys() == set(fields or a.keys())
            for k in a:
                assert (a[k].dtype, a[k].shape, a[k].tobytes()) == (
                    b[k].dtype, b[k].shape, b[k].tobytes()), k


@pytest.mark.parametrize("n_images,batch_size", [
    (6, 2),  # the batch size divides the count
    (5, 2),  # a short last batch, padded
    (6, 4),  # a short last batch of two
    (3, 3),  # a single batch
])
def test_folder_inference_bitwise(tiny, n_images, batch_size):
    images = tiny.images[:n_images]
    infer.reset_pipeline()
    got = infer.folder_inference(tiny.model, images, K, batch_size=batch_size)
    batches = -(-n_images // batch_size)
    assert infer.PIPELINE == {"batches": batches, "ahead": batches - 1}
    _assert_bitwise(got, _one_batch_at_a_time(tiny.model, images, batch_size))
    for persons in got:  # near to far, each with the image's cameras
        depths = [float(p["transl"][2]) for p in persons]
        assert depths == sorted(depths)
        assert all(np.array_equal(p["K"], K) and p["fov"].shape == (1,) for p in persons)


@pytest.mark.parametrize("fields", [["loc", "v3d"], ["fov", "K_regressed", "rotmat"]])
def test_fields_restrict_the_readback(tiny, fields):
    images = tiny.images[:4]
    got = infer.folder_inference(tiny.model, images, K, batch_size=2, fields=fields)
    full = infer.folder_inference(tiny.model, images, K, batch_size=2)
    _assert_bitwise(got, _one_batch_at_a_time(tiny.model, images, 2, fields), fields)
    for g, f in zip(got, full):  # the same persons, in the same order
        for a, b in zip(g, f):
            assert all(np.array_equal(a[k], b[k]) for k in fields)


def test_replica(tiny):
    model = tiny.model
    assert model.replica("cpu") is model
    twin = model.replica(torch.device("cpu", 0))  # another device name: a copy
    assert twin is not model and twin.net is not model.net
    assert twin.body_model.base.v_template is not model.body_model.base.v_template
    assert twin.net.useful_rotmat.device.type == "cpu"
    images = tiny.images[:2]
    _assert_bitwise(infer.folder_inference(twin, images, K, batch_size=2),
                    infer.folder_inference(model, images, K, batch_size=2))


def _ours(events):
    return sorted((e for e in events if e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda e: e.time_range.start)


def test_spans_in_order(tiny):
    """Each batch: ``vit``, then ``head`` holding ``decoder``, then ``body``
    holding ``fk``; the pipelined loop reads the batches back last."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer.folder_inference(tiny.model, tiny.images[:4], K, batch_size=2)
    spans = _ours(prof.events())
    batch = ["stack", "upload", "vit", "head", "decoder", "body", "fk"]
    assert [e.name for e in spans] == ["multihmr." + n for n in batch * 2 + ["readback"] * 2]
    inside = {"multihmr.decoder": ["multihmr.head"], "multihmr.fk": ["multihmr.body"]}
    for e in spans:
        outer, parent = [], e.cpu_parent
        while parent is not None:
            if parent.name.startswith(profiling.SPAN_PREFIX):
                outer.append(parent.name)
            parent = parent.cpu_parent
        assert outer == inside.get(e.name, []), e.name


@pytest.mark.parametrize("family,bones", [("anny", 163), ("smplx", 55)])
def test_fk_counts_compositions(tiny, family, bones):
    core.reset_fk()
    if family == "anny":
        _forward(tiny.model, tiny.images[:2])
    else:
        bm = core.BodyModel.from_arrays(synthetic_body_model(num_joints=55), "cpu")
        core.lbs_forward(bm, torch.eye(3).expand(3, 55, 3, 3), torch.zeros(3, 10))
    assert core.FK == {"calls": 1, "steps": bones}


def _loop_fk(rotmats, joints, parents):
    """The forward kinematics as the plain loop has always composed them."""
    world_R, world_t = [], []
    for j, p in enumerate(parents):
        if p < 0:
            world_R.append(rotmats[:, j])
            world_t.append(joints[:, j])
        else:
            world_R.append(world_R[p] @ rotmats[:, j])
            world_t.append((world_R[p] @ (joints[:, j] - joints[:, p])[..., None])[..., 0]
                           + world_t[p])
    Rw, posed = torch.stack(world_R, dim=1), torch.stack(world_t, dim=1)
    return posed, Rw, posed - torch.einsum("bjmn,bjn->bjm", Rw, joints)


def _fk_inputs(parents, n, seed=0):
    """Seeded rotations ``[n, J, 3, 3]`` and rest joints ``[n, J, 3]``."""
    g = torch.Generator().manual_seed(seed)
    J = len(parents)
    return (torch.linalg.qr(torch.randn(n, J, 3, 3, generator=g)).Q,
            torch.randn(n, J, 3, generator=g))


# (on a card, under inference_mode, compiling, capturing) -> whether the graph engages
GRAPH_CONDITIONS = {
    "card": ((True, True, False, False), True),
    "cpu": ((False, True, False, False), False),
    "grad": ((True, False, False, False), False),
    "compiling": ((True, True, True, False), False),
    "capturing": ((True, True, False, True), False),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CONDITIONS))
def test_fk_graph_engages_only_on_card_in_inference(tiny, monkeypatch, case):
    """``_graph_engages`` on a stand-in for a card tensor, with the tracer's
    and the capture's state set; then, in each case but the card's, the real
    forward kinematics on the CPU under the same state: the plain loop, no
    capture or replay, and the outputs bitwise those of the loop."""
    (cuda, inference, compiling, capturing), engages = GRAPH_CONDITIONS[case]
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: compiling)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    mode = torch.inference_mode if inference else torch.enable_grad
    with mode():
        assert core._graph_engages(SimpleNamespace(is_cuda=cuda)) is engages
    if engages:
        return
    parents = tiny.model.body_model.base.parents
    rotmats, joints = _fk_inputs(parents, 6)
    core.reset_fk()
    with mode():
        got = core._forward_kinematics(rotmats, joints, parents)
    assert core.FK_GRAPH == {"captures": 0, "replays": 0}
    assert core.FK == {"calls": 1, "steps": len(parents)}
    for a, b in zip(got, _loop_fk(rotmats, joints, parents)):
        assert (a.dtype, a.shape, a.numpy().tobytes()) == (b.dtype, b.shape, b.numpy().tobytes())


def test_fk_gradients_flow_through_the_loop(tiny):
    """With grad on, the gradients of the rotations and the joints are those
    of the plain loop, bitwise."""
    parents = tiny.model.body_model.base.parents
    weights = [torch.randn(o.shape, generator=torch.Generator().manual_seed(9))
               for o in _loop_fk(*_fk_inputs(parents, 4), parents)]
    grads = []
    for fk in (core._forward_kinematics, _loop_fk):
        rotmats, joints = (x.requires_grad_() for x in _fk_inputs(parents, 4))
        loss = sum((o * w).sum() for o, w in zip(fk(rotmats, joints, parents), weights))
        grads.append(torch.autograd.grad(loss, (rotmats, joints)))
    assert core.FK_GRAPH == {"captures": 0, "replays": 0}
    for a, b in zip(*grads):
        assert a.abs().sum() > 0
        assert torch.equal(a, b)


def _against_reference(tiny, bf16_decoder=False):
    """The largest |port - reference| of each field over the tiny images;
    the detections must be the reference's, cell for cell."""
    model = tiny.model
    if bf16_decoder:  # a model of its own, with the same weights
        net = weights_anny.load(MultiHMRAnnyNet, CFG, tiny_config(), SEED, "cpu").eval()
        model = MultiHMRAnny(CFG, tiny.model.body_model, net=net)
        dec = model.net.decoder.to(torch.bfloat16)
        sound = dec.forward
        dec.forward = lambda q, ctx, m: sound(q.bfloat16(), ctx.bfloat16(), m.bfloat16()).float()
    out = _forward(model, tiny.images)
    err = dict.fromkeys(TOLS, 0.0)
    with torch.no_grad():
        for b, x in enumerate(tiny.images):
            f = tiny.ref.features(torch.from_numpy(x))
            rows, cols = tiny.ref.detect(f["scores"])
            n = int(out["det"].valid[b].sum())
            assert n == len(rows) > 0
            assert torch.equal(out["det"].rows[b, :n], rows)
            assert torch.equal(out["det"].cols[b, :n], cols)
            r = tiny.ref.head(f, rows, cols, torch.from_numpy(K))
            r["fov"] = f["fov"].reshape(1)
            for k in TOLS:
                a = out["fov_regressed"][b] if k == "fov" else out[k][b, :n]
                err[k] = max(err[k], float((a - r[k]).abs().max()))
    return err


def test_port_matches_reference_fp32(tiny):
    err = _against_reference(tiny)
    assert all(err[k] <= tol for k, tol in TOLS.items()), err


def test_bf16_decoder_fails_the_tolerances(tiny):
    err = _against_reference(tiny, bf16_decoder=True)
    over = [k for k, tol in TOLS.items() if err[k] > tol]
    assert {"loc", "transl", "rotmat", "shape", "v3d", "j3d"} <= set(over), err
