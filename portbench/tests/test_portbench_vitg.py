"""The ViT-g/14 cell (``folder_896G_b8``) on the CPU at a tiny size of its
own: a 2-block, 32-wide SwiGLU ViT (hidden 88) at 112 px, 4 person slots,
the synthetic body at 300 vertices, fp32 (the port's
``factory.smplx_config`` swapped for the same sizes, as the loop holds the
file to it), through ``harness.run`` with the committed limits; answers
broken underneath come out not correct; and the control reads further than
the program."""

import pytest

from portbench import harness
from portbench.tests import tiny

WORKLOAD = "folder_896G_b8"
SIZES = dict(img_size=112, embed_dim=32, depth=2, num_heads=2, ffn_hidden=88, max_people=4)


def config() -> dict:
    c = harness.load_json(harness.ROOT / "configs" / "multiHMR_896_G.json")
    c.update(SIZES, name="tiny_g", compute_dtype="float32",
             body_model=dict(c["body_model"], num_vertices=300))
    return c


@pytest.fixture
def vitg_config(monkeypatch):
    """The port's ``smplx_config`` at the tiny sizes."""
    from multihmr_tpu_torch import factory
    from multihmr_tpu_torch.config import ModelConfig
    from multihmr_tpu_torch.port_config import PortViTConfig

    s = SIZES
    cfg = ModelConfig(backbone="dinov2_vitg14", img_size=s["img_size"],
                      max_people=s["max_people"], compute_dtype="float32",
                      vit_override=PortViTConfig(embed_dim=s["embed_dim"], depth=s["depth"],
                                                 num_heads=s["num_heads"],
                                                 ffn_layer="swiglufused"))
    monkeypatch.setattr(factory, "smplx_config", lambda name: cfg)
    return cfg


def cell(trace: bool = False, seed: int = 2**31 + 11):
    c = harness.cell_from_manifest(tiny.manifest(held=False), WORKLOAD, seed, 1.0, trace, "cpu")
    c.config = config()
    c.traffic = dict(c.traffic, frame_sizes=tiny.FRAMES, per_size=2, batch=2, trace_at_s=0.2,
                     trace_s=0.3)
    return c


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
def test_vitg_cell_on_cpu(vitg_config, trace):
    c = cell(trace=trace)
    result = harness.run(c, 0.0)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result
    assert set(result["checks"]) == set(c.limits)
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in c.per_layer}
        assert "mfu.infer" in result["metrics"]  # the span readers need device work
        assert result["metrics"]["fk_steps.infer"]["value"] == 55.0  # SMPL-X's bones
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert set(result["metrics"]) == {"images_per_s", "setup_s"}


def test_config_differing_from_the_port_is_refused(vitg_config):
    from portbench.loops import folder_g

    assert folder_g.model_config(config()) == vitg_config
    for key, value in (("depth", 3), ("ffn_hidden", 96), ("ffn_layer", "mlp"), ("hph_dim", 512)):
        with pytest.raises(ValueError, match="smplx_config"):
            folder_g.model_config(dict(config(), **{key: value}))


@pytest.mark.parametrize("fault", ["one_person", "moved"])
def test_broken_answer_fails(vitg_config, monkeypatch, fault):
    """Each image's first person alone, or the first person moved by 0.5 m."""
    from multihmr_tpu_torch.models import multihmr

    sound = multihmr.persons_from_host

    def broken(host):
        persons = sound(host)
        if fault == "one_person":
            return [image[:1] for image in persons]
        for image in persons:
            if image:
                image[0]["transl"] = image[0]["transl"] + 0.5
        return persons
    monkeypatch.setattr(multihmr, "persons_from_host", broken)
    result = harness.run(cell(), 0.0)
    assert not result["correct"], result["checks"]


def test_control_reads_further_on_cpu(vitg_config):
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
