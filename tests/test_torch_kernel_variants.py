"""The textual kernel variants against the CUDA sources, on the CPU.

chip_smoke.py phase 12 builds deliberately broken copies of K5, K1, K3, K4a,
K4b and K2 (``kernel_timing.MUTANTS``), and tools/kernel_timing.py builds K1,
K3, K4a, K4b, K5 and K2 with parts of their work removed
(``kernel_timing.VARIANTS``), each from its kernel's source with (old, new) substitutions
(``cuda_lib.build_variants``, which raises on a site it does not find exactly
once). The builds run only on the card; these tests keep every site present
and unique in the sources as the kernels change.
"""

import pytest

from multihmr_tpu_torch.ops import cuda_lib
from multihmr_tpu_torch.tools import kernel_timing
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

TABLES = (list(kernel_timing.MUTANTS.values())
          + [(source, table) for (source, _, _), table in kernel_timing.VARIANTS.items()])
CASES = [(source, name, subs) for source, table in TABLES for name, subs in table.items()]


@pytest.mark.parametrize("source,name,subs", CASES, ids=[f"{s}:{n}" for s, n, _ in CASES])
def test_variant_sites_are_unique(source, name, subs):
    text = (cuda_lib.CSRC / source).read_text()
    for old, new in subs:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
        assert new in text


def test_mutant_counts():
    assert {k: len(table) for k, (_, table) in kernel_timing.MUTANTS.items()} == {
        "K5": 4, "K1": 2, "K3": 2, "K4a": 2, "K4b": 2, "K2": 2}


def test_variant_tables_cover_each_kernel():
    """kernel_timing's ablations: K1 without each of its S product, P.V,
    exp2, TMA copies and ping-pong, with accurate exp2f, and with every exp2
    on the SFU; K5 without each of its S product, P.V,
    exp2 and copies; K2 without its variance pass and its stores; K4a
    (mode 1) and K4b (mode 2) without each of their S, dP and output
    products, their exp2 and their copies, K3 (mode 0) also without its dq
    product and reduce."""
    tables = {}
    for (source, _, modes), table in kernel_timing.VARIANTS.items():
        for mode in modes or (None,):
            tables.setdefault((source, mode), set()).update(table)
    assert tables[("flash_fwd.cu", None)] == {
        "no S = q k^T product", "no P.V product", "no exp2", "exp2f (accurate) for ex2.approx",
        "exp2 all on the SFU", "no ping-pong between the consumer warpgroups",
        "no k/v copies after the first kStages tiles"}
    assert {"no S = q k^T product", "no P.V product", "no exp2",
            "no k/v copies after the first kStages tiles"} <= tables[("flash_fwd_std.cu", None)]
    assert tables[("layernorm_cm.cu", None)] == {"no variance pass", "no stores"}
    assert {"K4a no S = q k^T product", "K4a no dP = dO v^T product", "K4a no dq product",
            "K4a no exp2", "K4a no k/v copies after the first kStages - 1 tiles"} <= tables[
        ("flash_bwd.cu", 1)]
    k4b = {"no S^T product", "no dP^T product", "no dV/dK products", "no exp2",
           "no q/dO copies after the first tile"}
    assert k4b <= tables[("flash_bwd.cu", 2)]
    assert k4b | {"no dq product", "no dq bulk reduce"} <= tables[("flash_bwd.cu", 0)]


@pytest.mark.parametrize("table", ["K4A_MUTANTS", "K4B_MUTANTS"])
def test_two_pass_mutants_leave_k3_alone(table):
    """K4b shares its kernel's text with K3: each K4b mutant changes only
    the kDq = false instance, and no K4a mutant touches K3's kernel."""
    text = (cuda_lib.CSRC / "flash_bwd.cu").read_text()
    k3 = text[text.index("flash_bwd_dkv_bf16_kernel("):text.index("flash_bwd_dq_bf16_kernel(")]
    for subs in getattr(kernel_timing, table).values():
        for old, new in subs:
            if table == "K4A_MUTANTS":
                assert old not in k3
            else:
                assert old in k3 and "kDq ?" in new


def test_build_variants_refuses_a_missing_site(tmp_path):
    with pytest.raises(ValueError, match="not once"):
        cuda_lib.build_variants("flash_fwd.cu", {"x": [("no such text", "")]}, tmp_path)


@pytest.mark.parametrize("argv", [["variants"], ["forward"], ["ab", "."], ["ptxas"], ["exp2"]])
def test_kernel_timing_needs_a_card(argv, capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert kernel_timing.main(argv) == 2
    assert "no CUDA card" in capsys.readouterr().err
