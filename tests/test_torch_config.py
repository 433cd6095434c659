"""The port's own config module equals the JAX package's, field for field.

``multihmr_tpu_torch/config.py`` is a copy of ``multihmr_tpu/config.py`` so
that the port imports nothing of the JAX package. Exact equality: field
names, types and defaults, the backbone presets, every named configuration
and every derived property.
"""

import dataclasses

import pytest

from multihmr_tpu import config as jcfg
from multihmr_tpu_torch import config as tcfg

NAMES = ("multiHMR_896_L", "multiHMR_672_L", "multiHMR_672_B", "multiHMR_672_S",
         "multiHMR_1288_L_bedlam", "multiHMR_1288_L_agora")
PROPS = ("vit", "patch_size", "grid_size", "num_patches", "camera_embed_dim", "hph",
         "npose", "token_dim")


def _fields(cls):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ViTConfig", "HPHConfig", "ModelConfig"])
def test_fields_and_defaults_equal(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_backbone_presets_equal():
    for preset in ("VITS", "VITB", "VITL"):
        a, b = getattr(tcfg, preset), getattr(jcfg, preset)
        assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.head_dim == b.head_dim
    assert {k: dataclasses.asdict(v) for k, v in tcfg._BACKBONES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg._BACKBONES.items()}


@pytest.mark.parametrize("name", NAMES)
def test_named_configs_equal(name):
    a, b = tcfg.named_config(name), jcfg.named_config(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in PROPS:
        va, vb = getattr(a, prop), getattr(b, prop)
        if dataclasses.is_dataclass(va):
            va, vb = dataclasses.asdict(va), dataclasses.asdict(vb)
        assert va == vb, prop


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="Unknown model name"):
        tcfg.named_config("multiHMR_1_X")


def test_vit_override_property():
    small = tcfg.ViTConfig(embed_dim=32, depth=2, num_heads=2)
    cfg = tcfg.ModelConfig(img_size=56, vit_override=small)
    assert cfg.vit is small and cfg.grid_size == 4 and cfg.token_dim == 318 + 10 + 3 + 32 + 99
