"""The port's auto remat-policy selection (``multihmr_tpu_torch/train/memory.py``).

Its constants are fitted to peaks that ``chip_smoke.py`` phase 10 measured
on one H100 80GB (896_L, bf16 backbone, batch 1 and 2, both ViT streams):
13.24 GiB for the standard stream and 12.48 GiB for the channels-major one
at batch 2 with no remat, 9.86 / 9.11 with "mlp", 6.13 with "block". These
tests pin that the estimate stays above every measured peak by at most a
few GB (conservative, not wasteful), that the chooser is monotonic, and the
CLI flag semantics, which are the JAX package's. CPU tests pass an explicit
limit.
"""

import pytest

from multihmr_tpu.train import memory as jmem
from multihmr_tpu_torch.config import named_config
from multihmr_tpu_torch.train.memory import (
    approx_param_count,
    choose_remat,
    device_hbm_limit,
    estimate_train_hbm_bytes,
    resolve_remat_flags,
    token_dims,
)
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

H100 = 80e9
GIB = 2 ** 30
# (policy, batch) -> the larger measured peak of the two streams, bytes
MEASURED = {("none", 2): 13.24 * GIB, ("none", 1): 9.35 * GIB, ("mlp", 2): 9.86 * GIB,
            ("mlp", 1): 7.47 * GIB, ("block", 2): 6.13 * GIB, ("block", 1): 6.11 * GIB}


@pytest.mark.parametrize("policy,batch", sorted(MEASURED))
def test_estimate_covers_measured_peaks(policy, batch):
    est = estimate_train_hbm_bytes(named_config("multiHMR_896_L"), batch, policy)
    assert MEASURED[(policy, batch)] <= est <= MEASURED[(policy, batch)] + 2e9


def test_choices_on_the_h100():
    # 896_L at the CLI's batches: no remat fits the 80 GB card
    for b in (1, 2, 8):
        remat, _, rep = choose_remat(named_config("multiHMR_896_L"), b, hbm_limit_bytes=H100)
        assert not remat and rep["chosen"] == "none"
    # 896_L batch 20: the stash (~90 GB) does not fit, "mlp"'s (~58 GB) does
    remat, policy, _ = choose_remat(named_config("multiHMR_896_L"), 20, hbm_limit_bytes=H100)
    assert remat and policy == "mlp"
    # 1288_L batch 8: no remat would need ~76 GB, "mlp" fits
    remat, policy, _ = choose_remat(named_config("multiHMR_1288_L_bedlam"), 8,
                                    hbm_limit_bytes=H100)
    assert remat and policy == "mlp"


def test_monotonic_in_batch_and_policy():
    cfg = named_config("multiHMR_896_L")
    sizes = {"none": 0, "mlp": 1, "block": 2}
    prev = -1
    for b in (1, 2, 4, 8, 16, 32, 64):
        _, _, rep = choose_remat(cfg, b, hbm_limit_bytes=H100)
        assert sizes[rep["chosen"]] >= prev, b
        prev = sizes[rep["chosen"]]
    for b in (1, 4):
        e = {p: estimate_train_hbm_bytes(cfg, b, p) for p in sizes}
        assert e["none"] > e["mlp"] > e["block"]


def test_pinned_policy_and_cli_semantics():
    cfg = named_config("multiHMR_896_L")
    assert choose_remat(cfg, 1, hbm_limit_bytes=H100, policy="block")[0] is False
    remat, policy, _ = choose_remat(cfg, 64, hbm_limit_bytes=H100, policy="block")
    assert remat and policy == "block"
    remat, _, rep = resolve_remat_flags("auto", None, cfg, 1, hbm_limit_bytes=H100)
    assert not remat and rep["chosen"] == "none"
    assert resolve_remat_flags("1", None, cfg, 1) == (True, "mlp", None)
    assert resolve_remat_flags("1", "block", cfg, 1) == (True, "block", None)
    assert resolve_remat_flags("0", None, cfg, 64)[::2] == (False, None)
    # a degenerate limit falls back to block and never raises
    assert choose_remat(cfg, 8, hbm_limit_bytes=2e9)[1] == "block"


def test_param_count_and_token_dims():
    cfg = named_config("multiHMR_896_L")
    assert approx_param_count(cfg) == jmem.approx_param_count(cfg)  # the JAX analytic count
    assert token_dims(cfg, 1) == 4097 * 1024 * 24


def test_device_limit_on_the_cpu():
    assert device_hbm_limit("cpu") > 1e9  # the host's memory
