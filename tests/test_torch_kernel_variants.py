"""The textual kernel variants against the CUDA sources, on the CPU.

chip_smoke.py phase 12 builds deliberately broken copies of K5, K1 and K3,
and tools/kernel_timing.py builds K1 and K3 with parts of their work removed,
each from its kernel's source with (old, new) substitutions
(``cuda_lib.build_variants``, which raises on a site it does not find exactly
once). The builds run only on the card; these tests keep every site present
and unique in the sources as the kernels change.
"""

import pytest

import chip_smoke
from multihmr_tpu_torch.ops import cuda_lib
from multihmr_tpu_torch.tools import kernel_timing

TABLES = ([("flash_fwd_std.cu", chip_smoke.K5_MUTANTS), ("flash_fwd.cu", chip_smoke.K1_MUTANTS),
           ("flash_bwd.cu", chip_smoke.K3_MUTANTS)]
          + [(source, table) for (source, _), table in kernel_timing.VARIANTS.items()])
CASES = [(source, name, subs) for source, table in TABLES for name, subs in table.items()]


@pytest.mark.parametrize("source,name,subs", CASES, ids=[f"{s}:{n}" for s, n, _ in CASES])
def test_variant_sites_are_unique(source, name, subs):
    text = (cuda_lib.CSRC / source).read_text()
    for old, new in subs:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
        assert new in text


def test_mutant_counts():
    assert (len(chip_smoke.K5_MUTANTS), len(chip_smoke.K1_MUTANTS),
            len(chip_smoke.K3_MUTANTS)) == (4, 2, 2)


def test_build_variants_refuses_a_missing_site(tmp_path):
    with pytest.raises(ValueError, match="not once"):
        cuda_lib.build_variants("flash_fwd.cu", {"x": [("no such text", "")]}, tmp_path)


@pytest.mark.parametrize("argv", [["variants"], ["forward"], ["ab", "."]])
def test_kernel_timing_needs_a_card(argv, capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert kernel_timing.main(argv) == 2
    assert "no CUDA card" in capsys.readouterr().err
