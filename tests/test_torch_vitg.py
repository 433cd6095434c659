"""Multi-HMR on DINOv2's ViT-g/14 geometry (``port_config.py``: a fused
SwiGLU FFN in place of the GELU MLP), on the CPU at a tiny size: a 2-block,
32-wide SwiGLU ViT (hidden 88) at 112 px with 4 person slots, fp32, the
synthetic SMPL-X-sized body at 300 vertices, and the benchmark's seeded
weights (``portbench/weights_vitg.py``, SwiGLU biases non-zero):

* both streams through ``folder_inference`` and ``extract_persons`` against
  the plain reference ``portbench/reference/vitg.py``: the same cells, and
  every field within a tolerance that each of three broken FFNs (GELU in
  place of the SiLU gate, SiLU on the second half, ``w3``'s bias dropped)
  exceeds by orders of magnitude;
* the ``multihmr.ffn`` span once a block inside ``multihmr.vit``, on the
  SwiGLU path only; ``remat_policy="mlp"`` recomputes it bitwise;
* ``multiHMR_896_G``'s sizes, kept out of ``config.py``; the factory, the
  bf16 cast, a 2-rank tensor-parallel forward equal to one rank's, the
  hub-key converter, and ``forward_flops``' count of the SwiGLU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from multihmr_tpu_torch import config as tconfig
from multihmr_tpu_torch import factory
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.config import ModelConfig
from multihmr_tpu_torch.io import checkpoint as ckpt
from multihmr_tpu_torch.models import vit as tvit
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from multihmr_tpu_torch.parallel import infer
from multihmr_tpu_torch.port_config import PortViTConfig, ffn_hidden
from multihmr_tpu_torch.utils import profiling
from multihmr_tpu_torch.utils.precision import cast_backbone_bf16
from portbench import harness, inputs, judge, roofline, weights_vitg
from portbench.reference.vitg import VitgReference
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

S, SEED = 112, 7
VIT = PortViTConfig(embed_dim=32, depth=2, num_heads=2, ffn_layer="swiglufused")
CFG = ModelConfig(backbone="dinov2_vitg14", img_size=S, max_people=4, compute_dtype="float32",
                  vit_override=VIT)
K = inputs.camera_K(S, 60)

# |port - reference| on the CPU in fp32 at most these, per field (the
# judge's numbers: largest over the persons of the sampled images). Both
# sides compute in fp32, the same sums in other orders, so they part by a
# few ulps of each field's scale (measured, the larger of the two streams:
# logits 1.4e-6, loc 1.5e-5 px on ~60 px, transl 9.5e-7 m at ~4.5 m,
# rotations 2.4e-7, shape 4.5e-8, meshes 1.7e-6 m); the least that a broken
# FFN reads (of GELU gate, SiLU on the second half, w3's bias dropped):
# logits 0.082, loc 0.38 px, transl 0.018 m, rotations 1.1e-3, shape
# 6.3e-4, meshes 2.4e-3 m.
TOLS = {
    "select_gap": 0.0,  # the same cells: the reference's choice exactly
    "count_err": 0.0,  # as many persons as the reference's NMS and top-K
    "logit_err": 1e-4,  # 70 x the measured, 1/800 of a broken FFN's
    "loc_err": 1e-3,  # px: 65 x the measured, 1/380 of a broken FFN's
    "transl_err": 2e-5,  # m: 20 x the measured, 1/900 of a broken FFN's
    "pelvis_err": 2e-5,  # m: as transl
    "rot_err": 1e-5,  # 40 x the measured, 1/110 of a broken FFN's
    "shape_err": 1e-5,  # 220 x the measured, 1/63 of a broken FFN's
    "mesh_err": 2e-5,  # m: 12 x the measured, 1/120 of a broken FFN's
}


def tiny_config() -> dict:
    """The configuration file's dict at the tiny size."""
    c = harness.load_json(harness.ROOT / "configs" / "multiHMR_896_G.json")
    c.update(name="tiny_g", img_size=S, embed_dim=32, depth=2, num_heads=2,
             ffn_hidden=ffn_hidden(VIT), max_people=4, compute_dtype="float32",
             body_model=dict(c["body_model"], num_vertices=300))
    return c


@pytest.fixture(scope="module")
def tiny():
    c = tiny_config()
    shapes, norms = weights_vitg.layout(MultiHMRNet, CFG)
    w = weights_vitg.draw(shapes, norms, c, SEED, "cpu")
    body = inputs.body_model(c["body_model"], SEED)
    frames = inputs.frames([[64, 48], [96, 160], [112, 112]], 2, SEED, "cpu")
    images = [inputs.normalize(inputs.contain_pad(f, S)) for f in frames]
    ref = VitgReference(c, w, body, "cpu")
    models = {}
    for tp_mode in ("heads", "ring"):
        with torch.device("meta"):
            net = MultiHMRNet(CFG, tp_mode=tp_mode)
        net.load_state_dict(w, strict=True, assign=True)
        models[tp_mode] = MultiHMR(CFG, BodyModel.from_arrays(body, "cpu"), net=net.eval(),
                                   tp_mode=tp_mode)
    return dataclasses.make_dataclass("Tiny", ["models", "images", "ref", "w"])(
        models, images, ref, w)


def _compare(tiny, model) -> dict:
    """The judge's numbers of ``model``'s persons (``folder_inference`` at
    batch 4, then ``extract_persons`` of one forward) against the reference."""
    got = infer.folder_inference(model, tiny.images, K, batch_size=4)
    x = torch.from_numpy(np.stack(tiny.images[:2]))
    with torch.inference_mode():
        one = model.extract_persons(model.forward(x, torch.from_numpy(np.stack([K] * 2))))
    tally = judge.Tally()
    for x_i, persons in zip(tiny.images + tiny.images[:2], got + one):
        judge.judge_image(tiny.ref, x_i, K, persons, tally)
    return tally.numbers()


@pytest.mark.parametrize("tp_mode", ["heads", "ring"])
def test_port_against_reference(tiny, tp_mode):
    numbers = _compare(tiny, tiny.models[tp_mode])
    assert numbers["persons_err"] == 0
    for k, tol in TOLS.items():
        assert numbers[k] <= tol, (k, numbers[k], tol)


def _gelu_gate(self, x):
    x1, x2 = self.w12(x).chunk(2, dim=1)
    return self.w3(tvit._gelu(x1) * x2)


def _silu_second(self, x):
    x1, x2 = self.w12(x).chunk(2, dim=1)
    return self.w3(x1 * torch.nn.functional.silu(x2))


def _no_w3_bias(self, x):
    x1, x2 = self.w12(x).chunk(2, dim=1)
    return self.w3(torch.nn.functional.silu(x1) * x2) - self.w3.bias[:, None]


MUTANTS = {"gelu gate": _gelu_gate, "silu on the second half": _silu_second,
           "w3 bias dropped": _no_w3_bias}


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_broken_ffn_fails_the_comparison(tiny, monkeypatch, mutant):
    monkeypatch.setattr(tvit.TSwiGLU, "forward", MUTANTS[mutant])
    numbers = _compare(tiny, tiny.models["heads"])
    failed = [k for k, tol in TOLS.items() if numbers[k] > 10 * tol]
    assert failed, numbers


def _ours(events):
    return [e for e in sorted(events, key=lambda e: e.time_range.start)
            if e.name.startswith(profiling.SPAN_PREFIX)]


def _outer(e):
    outer, parent = [], e.cpu_parent
    while parent is not None:
        if parent.name.startswith(profiling.SPAN_PREFIX):
            outer.append(parent.name)
        parent = parent.cpu_parent
    return outer


@pytest.mark.parametrize("tp_mode", ["heads", "ring"])
def test_ffn_span_inside_vit(tiny, tp_mode):
    """Each batch: ``vit`` holding one ``ffn`` a block, then ``head`` and
    ``body`` (holding ``fk``); a GELU backbone opens no ``ffn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer.folder_inference(tiny.models[tp_mode], tiny.images[:4], K, batch_size=2)
    spans = _ours(prof.events())
    ffn = [e for e in spans if e.name == "multihmr.ffn"]
    assert len(ffn) == 2 * CFG.vit.depth
    assert all(_outer(e) == ["multihmr.vit"] for e in ffn)
    assert [e.name for e in spans if not _outer(e)] == [
        "multihmr." + n for n in ["stack", "upload", "vit", "head", "body"] * 2
        + ["readback"] * 2]

    gelu = dataclasses.replace(CFG, vit_override=tconfig.ViTConfig(embed_dim=32, depth=2,
                                                                    num_heads=2))
    model = MultiHMR(gelu, BodyModel.from_arrays(inputs.body_model(
        tiny_config()["body_model"], SEED), "cpu"),
        net=MultiHMRNet(gelu, tp_mode=tp_mode).init_weights(torch.Generator().manual_seed(0)),
        tp_mode=tp_mode)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer.folder_inference(model, tiny.images[:2], K, batch_size=2)
    assert not [e for e in _ours(prof.events()) if e.name == "multihmr.ffn"]


@pytest.mark.parametrize("tp_mode", ["heads", "ring"])
def test_remat_mlp_recomputes_the_swiglu(tiny, tp_mode):
    """``remat_policy="mlp"`` checkpoints the SwiGLU: the same outputs and
    gradients, bitwise, and the FFN runs twice a block in the backward."""
    grads, calls = {}, {}
    x = torch.from_numpy(np.stack(tiny.images[:2]))
    for remat in (None, "mlp"):
        vit = tvit.DINOv2ViT(VIT, S // 14, torch.float32, remat_policy=remat, tp_mode=tp_mode)
        vit.init_weights(torch.Generator().manual_seed(1))
        cls = tvit.TSwiGLU if tp_mode == "heads" else tvit.SwiGLU
        count = [0]
        # a pre-hook: the recomputation stops once it has what the backward needs
        hooks = [m.register_forward_pre_hook(lambda *a: count.__setitem__(0, count[0] + 1))
                 for m in vit.modules() if isinstance(m, cls)]
        assert len(hooks) == VIT.depth
        out = vit(x)["patch_tokens"]
        (out * out).sum().backward()
        grads[remat] = (out.detach(), {n: p.grad for n, p in vit.named_parameters()})
        calls[remat] = count[0]
    assert calls == {None: VIT.depth, "mlp": 2 * VIT.depth}
    assert torch.equal(grads[None][0], grads["mlp"][0])
    for n, g in grads[None][1].items():
        assert torch.equal(g, grads["mlp"][1][n]), n


def test_giant_sizes():
    cfg = factory.smplx_config("multiHMR_896_G")
    vit = cfg.vit
    assert (vit.embed_dim, vit.depth, vit.num_heads, vit.head_dim, vit.patch_size) == (
        1536, 40, 24, 64, 14)
    assert (vit.ffn_layer, ffn_hidden(vit), cfg.token_dim) == ("swiglufused", 4096, 1966)
    assert (cfg.img_size, cfg.hph, cfg.backbone) == (
        896, tconfig.named_config("multiHMR_896_L").hph, "dinov2_vitg14")
    with torch.device("meta"):
        net = MultiHMRNet(cfg)
    blk = net.backbone.blocks[0].mlp
    assert isinstance(blk, tvit.TSwiGLU)
    assert (tuple(blk.w12.weight.shape), tuple(blk.w3.weight.shape)) == ((8192, 1536),
                                                                          (1536, 4096))
    n = sum(p.numel() for p in net.backbone.blocks.parameters())
    assert n == 40 * (1536 * 4608 + 4608 + 1536 * 1536 + 1536 + 1536 * 8192 + 8192
                      + 4096 * 1536 + 1536 + 6 * 1536)  # 1.13 B, DINOv2's "1.1 B"


def test_config_py_stays_the_jax_copy():
    """The giant is the port's own: ``config.py`` (held to the JAX package's
    by ``test_torch_config.py``) knows neither the name nor the backbone,
    and a config without ``ffn_layer`` keeps the GELU MLP."""
    with pytest.raises(KeyError):
        tconfig.named_config("multiHMR_896_G")
    assert "dinov2_vitg14" not in tconfig._BACKBONES
    assert not any(f.name == "ffn_layer" for f in dataclasses.fields(tconfig.ViTConfig))
    with torch.device("meta"):
        net = MultiHMRNet(tconfig.named_config("multiHMR_896_L"))
    assert isinstance(net.backbone.blocks[0].mlp, tvit.TMlp)
    with pytest.raises(ValueError, match="ffn_layer"):
        PortViTConfig(embed_dim=32, depth=2, num_heads=2, ffn_layer="swiglu")


def test_factory_builds_the_name():
    assert "multiHMR_896_G" in factory.SMPLX_NAMES
    host = factory.build_host_model("multiHMR_896_G")
    assert host.cfg.vit.ffn_layer == "swiglufused"
    assert isinstance(host.net.backbone.blocks[39].mlp, tvit.TSwiGLU)
    with pytest.raises(KeyError, match="not a ported configuration"):
        factory.smplx_config("multiHMR_896_X")


def test_cast_backbone_bf16_casts_the_swiglu():
    net = MultiHMRNet(CFG).init_weights(torch.Generator().manual_seed(0))
    cast_backbone_bf16(net)
    for name, p in net.backbone.named_parameters():
        want = torch.float32 if ".norm" in name or name.startswith("norm.") else torch.bfloat16
        assert p.dtype == want, name
    assert net.backbone.blocks[1].mlp.w12.weight.dtype == torch.bfloat16
    assert net.backbone.blocks[1].mlp.w3.bias.dtype == torch.bfloat16


def test_two_rank_forward_equals_one(tmp_path):
    """The channels-major SwiGLU ViT with its heads and FFN cut over a
    2-rank ``model`` axis (gloo) gives one rank's outputs."""
    from multihmr_tpu_torch.parallel.launch import run_ranks
    from tests import torch_parallel_ranks

    vit = tvit.DINOv2ViT(VIT, 4, torch.float32)
    vit.init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():
        for p in vit.parameters():  # biases and LayerNorms off their init values too
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    x = torch.randn((2, 56, 56, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = vit(x)
    path = str(tmp_path / "vit.pt")
    torch.save({"state": vit.state_dict(), "x": x}, path)
    for got in run_ranks(torch_parallel_ranks.swiglu_vit_tp, 2, args=(VIT, 4, path)):
        for k in ("patch_tokens", "cls_token"):
            np.testing.assert_allclose(got[k], want[k].double().numpy(), rtol=1e-5, atol=1e-5)


def _hub_state_dict(cfg, rng) -> dict:
    """Every key the converter consumes for ``cfg``, in the hub's naming and
    shapes (a 4 x 4 source grid for ``pos_embed``), drawn from ``rng``."""
    fill = {"backbone.encoder.pos_embed": 1 + 4 * 4}
    return {k: rng.normal(size=[d if d is not None else fill.get(k, 1) for d in shape]).astype(
        np.float32) for k, shape in ckpt.expected_reference_shapes(cfg).items()}


def test_converter_maps_the_hub_swiglu_keys(tmp_path):
    sd = _hub_state_dict(CFG, np.random.default_rng(0))
    assert "backbone.encoder.blocks.1.mlp.w12.weight" in sd
    assert not any(".fc1." in k or ".fc2." in k for k in sd if ".blocks." in k)
    path = tmp_path / "multiHMR_896_G_tiny.pt"
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    port = ckpt.convert_reference_checkpoint(str(path), CFG)
    for i in range(VIT.depth):
        for name in ("w12.weight", "w12.bias", "w3.weight", "w3.bias"):
            np.testing.assert_array_equal(port[f"backbone.blocks.{i}.mlp.{name}"].numpy(),
                                          sd[f"backbone.encoder.blocks.{i}.mlp.{name}"])
    model = factory.build_model("multiHMR_896_G", device="cpu", cfg=CFG, checkpoint=str(path))
    assert torch.equal(model.net.backbone.blocks[0].mlp.w3.bias, port[
        "backbone.blocks.0.mlp.w3.bias"])
    missing = {k: v for k, v in sd.items() if ".mlp.w3." not in k}
    with pytest.raises(KeyError, match="mlp.w3"):
        ckpt.convert_reference_checkpoint(missing, CFG)
    args = {"backbone": "dinov2_vitg14", "img_size": [896]}
    assert ckpt.config_from_ckpt_args(args).vit == factory.smplx_config("multiHMR_896_G").vit


def _by_hand(c) -> int:
    """Two a multiply-add of each product of the SMPL-X forward, the ViT's
    FFN as DINOv2's SwiGLU: (rows, inner, columns, times)."""
    g = c["img_size"] // 14
    n, D, L, k, hd = 1 + g * g, c["embed_dim"], c["depth"], c["max_people"], c["hph_dim"]
    H, inner = c["ffn_hidden"], 256
    ctx = D + 3 + 6 * c["camera_embedding_num_bands"]
    tok = 6 * c["nrot"] + c["num_betas"] + 3 + ctx
    Ld, out = c["xat_depth"], 6 * c["nrot"] + c["num_betas"] + 3 + 10
    products = [
        (n - 1, 14 * 14 * 3, D, 1),  # patch embedding
        (n, D, 3 * D, L), (n, D, n, L), (n, n, D, L), (n, D, D, L),  # qkv, QK^T, PV, proj
        (n, D, 2 * H, L), (n, H, D, L),  # SwiGLU: w12 (both halves), w3
        (g * g, D, D, 1), (g * g, D, 1, 1), (g * g, D, D, 1), (g * g, D, 2, 1),  # score, offset
        (k, tok, hd, 1),  # token embedding
        (k, hd, 3 * inner, Ld), (k, inner, k, Ld), (k, k, inner, Ld), (k, inner, hd, Ld),
        (k, hd, inner, Ld), (g * g, ctx, 2 * inner, Ld), (k, inner, g * g, Ld),
        (k, g * g, inner, Ld), (k, inner, hd, Ld),  # cross-attention
        (k, hd, hd, Ld), (k, hd, hd, Ld),  # MLP
        (k, hd, out, 1),  # decoders
    ]
    return sum(2 * a * b * e * t for a, b, e, t in products)


def test_forward_flops_count_the_swiglu():
    c = harness.load_json(harness.ROOT / "configs" / "multiHMR_896_G.json")
    assert 2 * c["ffn_hidden"] + c["ffn_hidden"] == 2 * int(c["embed_dim"] * c["mlp_ratio"])
    assert roofline.forward_flops(c) == _by_hand(c)
    assert roofline.forward_flops(c) / 1e12 == pytest.approx(13.46, abs=0.01)
    # exact where 3 x hidden = 2 x 4 D, as at D = 1,536; not at the tiny 88 of 32
    assert roofline.forward_flops(tiny_config()) != _by_hand(tiny_config())
