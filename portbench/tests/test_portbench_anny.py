"""The Anny family's cell (``folder_672L_anny_b8``) on the CPU at a tiny
size of its own: a 2-block, 32-wide ViT at 112 px, a 2-deep 64-wide
decoder, the synthetic asset at 64 vertices, fp32 (the port's
``factory.anny_config`` swapped for the same sizes, as the loop holds the
file to it), through ``harness.run`` with the committed limits; answers
broken underneath come out not correct; and ``roofline_anny`` against a
count of its products by hand."""

import pytest

from portbench import harness, roofline_anny
from portbench.tests import tiny

WORKLOAD = "folder_672L_anny_b8"
SIZES = dict(img_size=112, embed_dim=32, depth=2, num_heads=2, xat_dim=64, xat_depth=2,
             xat_heads=4, xat_dim_head=16, xat_mlp_dim=128, max_people=4)


def config() -> dict:
    c = harness.load_json(harness.ROOT / "configs" / "multiHMR_672_L_anny.json")
    c.update(SIZES, name="tiny_anny", compute_dtype="float32",
             body_model=dict(c["body_model"], num_vertices=64))
    return c


@pytest.fixture
def anny_config(monkeypatch):
    """The port's ``anny_config`` at the tiny sizes."""
    from multihmr_tpu_torch import factory
    from multihmr_tpu_torch.config import ViTConfig
    from multihmr_tpu_torch.models.multihmr_anny import AnnyConfig

    s = SIZES
    cfg = AnnyConfig(img_size=s["img_size"], xat_dim=s["xat_dim"], xat_depth=s["xat_depth"],
                     xat_heads=s["xat_heads"], xat_dim_head=s["xat_dim_head"],
                     xat_mlp_dim=s["xat_mlp_dim"], max_people=s["max_people"],
                     compute_dtype="float32",
                     vit_override=ViTConfig(embed_dim=s["embed_dim"], depth=s["depth"],
                                            num_heads=s["num_heads"]))
    monkeypatch.setattr(factory, "anny_config", lambda name: cfg)
    return cfg


def cell(trace: bool = False, seed: int = 2**31 + 11):
    c = harness.cell_from_manifest(tiny.manifest(held=False), WORKLOAD, seed, 1.0, trace, "cpu")
    c.config = config()
    c.traffic = dict(c.traffic, frame_sizes=tiny.FRAMES, per_size=2, batch=2, trace_at_s=0.2,
                     trace_s=0.3)
    return c


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
def test_anny_cell_on_cpu(anny_config, trace):
    c = cell(trace=trace)
    result = harness.run(c, 0.0)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result
    assert set(result["checks"]) == set(c.limits)
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in c.per_layer}
        assert result["metrics"]["fk_steps.infer"]["value"] == 163.0
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {"images_per_s", "setup_s"}


def test_config_differing_from_the_port_is_refused(anny_config):
    from portbench import judge_anny

    assert judge_anny.model_config(config()) == anny_config
    with pytest.raises(ValueError, match="anny_config"):
        judge_anny.model_config(dict(config(), xat_depth=3))


@pytest.mark.parametrize("fault", ["one_person", "moved"])
def test_broken_answer_fails(anny_config, monkeypatch, fault):
    """Each image's first person alone (the persons left out, and the
    decoder's self-attention then ran with others beside it), or the first
    person moved by 0.5 m."""
    from multihmr_tpu_torch.models import multihmr_anny

    sound = multihmr_anny._anny_persons_from_host

    def broken(host):
        persons = sound(host)
        if fault == "one_person":
            return [image[:1] for image in persons]
        for image in persons:
            if image:
                image[0]["transl"] = image[0]["transl"] + 0.5
        return persons
    monkeypatch.setattr(multihmr_anny, "_anny_persons_from_host", broken)
    result = harness.run(cell(), 0.0)
    assert not result["correct"], result["checks"]


def test_control_reads_further_on_cpu(anny_config):
    c = cell(seed=2**31 + 201)
    drv = harness.loop(c)
    state = drv.setup(c)
    drv.window(c, state)
    pool = state.__dict__.copy()
    control = drv.control(c, state)
    state.__dict__.update(pool)
    program = drv.check(c, state)
    compared = [k for k in c.limits if program.get(k, 0) > 0]
    assert compared
    assert all(control[k] > program[k] for k in compared), (program, control)


def _by_hand(c) -> int:
    """Two a multiply-add of each product, listed one by one: (rows, inner,
    columns, times)."""
    n, D, g, k = 1 + (c["img_size"] // 14) ** 2, c["embed_dim"], c["img_size"] // 14, \
        c["max_people"]
    X, M, H = c["xat_dim"], c["xat_mlp_dim"], c["xat_heads"] * c["xat_dim_head"]
    J6, L, Ld = 6 * c["n_joints"], c["depth"], c["xat_depth"]
    products = [
        (n - 1, 14 * 14 * 3, D, 1),  # patch embedding
        (n, D, 3 * D, L), (n, D, n, L), (n, n, D, L), (n, D, D, L),  # qkv, QK^T, PV, proj
        (n, D, 4 * D, L), (n, 4 * D, D, L),  # MLP
        (g * g, D, D, 1), (g * g, D, 1, 1),  # detection MLP
        (1, D, D, 1), (1, D, 1, 1),  # FOV MLP
        (g * g, D, X, 1),  # dec_to_token
        (k, X, 3 * H, Ld), (k, H, k, Ld), (k, k, H, Ld), (k, H, X, Ld),  # self-attention
        (k, X, H, Ld), (g * g, X, 2 * H, Ld), (k, H, g * g, Ld), (k, g * g, H, Ld),
        (k, H, X, Ld),  # cross-attention: q, k/v, scores, values, out
        (k, X, M, Ld), (k, M, X, Ld),  # decoder MLP
        (k, X, X, 1), (k, X, 2, 1),  # offset
        (k, X + J6, X, 1), (k, X, J6, 1),  # pose
        (k, X, X, 1), (k, X, c["num_betas"], 1),  # phenotypes
        (k, X, X, 1), (k, X, 1, 1),  # distance
    ]
    return sum(2 * a * b * e * t for a, b, e, t in products)


def test_forward_flops_by_hand():
    c = config()
    assert roofline_anny.forward_flops(c) == _by_hand(c)
    full = harness.load_json(harness.ROOT / "configs" / "multiHMR_672_L_anny.json")
    assert roofline_anny.forward_flops(full) == _by_hand(full)
    assert roofline_anny.forward_flops(full) / 1e12 == pytest.approx(1.95, abs=0.01)

