"""The yardstick's counts reproduce the kernel table's bounds at 896_L."""

import pytest

from portbench import harness, roofline


def cfg(name):
    return harness.load_json(harness.ROOT / "configs" / f"{name}.json")


def test_kernel_bounds_896L():
    c = cfg("multiHMR_896_L")
    assert roofline.tokens(c) == 4097
    assert roofline.k1_bound_s(c, 1) * 1e3 == pytest.approx(0.0695, abs=5e-5)
    assert roofline.k3_bound_s(c, 1) * 1e3 == pytest.approx(0.1738, abs=5e-5)
    assert roofline.k1_bound_s(c, 8) == pytest.approx(8 * roofline.k1_bound_s(c, 1))


# multiHMR_672_B's widths (ViT-B/14 at 672 px; 768 wide, 12 deep, 12 heads, 768-wide head)
VIT_B_672 = dict(img_size=672, embed_dim=768, depth=12, num_heads=12, hph_dim=768)


@pytest.mark.parametrize("name,tflop", [("multiHMR_896_L", 4.13), ("multiHMR_672_B", 0.59)])
def test_forward_flops(name, tflop):
    c = cfg("multiHMR_896_L")
    if name == "multiHMR_672_B":
        c.update(VIT_B_672)
    assert roofline.forward_flops(c) / 1e12 == pytest.approx(tflop, rel=0.03)
    assert roofline.step_flops(c, 8) == pytest.approx(24 * roofline.forward_flops(c))
