"""Training-memory estimate and automatic remat-policy selection
(``multihmr_tpu/train/memory.py``).

Three rematerialisation levels (``ModelConfig.remat``/``remat_policy``) trade
step time against memory: ``none`` > ``mlp`` > ``block`` in speed (896_L,
batch 2, one H100: 338 / 357 / 423 ms per step, PERF.md §5), and the reverse
in peak memory. :func:`choose_remat` picks the FASTEST level whose estimated
peak fits the card, so ``--remat auto`` (the training CLI's default) takes no
remat where the stash fits and degrades to "mlp", then "block", where it does
not.

The estimate is linear in the ViT's token-dims (batch x tokens x embed dim x
depth): ``params * _BYTES_PER_PARAM + act[policy] * token_dims +
_FIXED_BYTES``. Calibration on one H100 80GB HBM3 (700 W), ``multiHMR_896_L``
with the bf16 backbone, 8 person slots, the synthetic SMPL-X-sized body
model, peaks of ``torch.cuda.max_memory_allocated`` over train steps
(``chip_smoke.py`` phase 10; PERF.md §5 has the numbers):

- ``_BYTES_PER_PARAM`` = 16: PyTorch's Adam keeps fp32 weights, fp32
  gradients and two fp32 moments (5.555 GB at 896_L);
- ``_ACT_BYTES_PER_TOKEN_DIM``: the slope of the peak between batch 1 and
  batch 2 per token-dim (100,687,872 per 896_L image), for each policy the
  larger of the two ViT streams. Peaks at batch 1 / 2 in GiB:
  channels-major none 8.97 / 12.48, mlp 7.09 / 9.11, block 6.11 / 6.13;
  standard none 9.35 / 13.24, mlp 7.47 / 9.86, block 6.11 / 6.13. Slopes:
  channels-major 37.51 / 21.50 / 0.18, standard 41.48 / 25.52 / 0.19 bytes.
  Under "block" the peak is the weights, Adam and one block's recompute, so
  it barely grows with the batch;
- ``_FIXED_BYTES``: the largest intercept left at batch 1 once the weights'
  bytes and the activations are taken off (0.30 GB none, -0.11 GB mlp,
  0.99 GB block): the bf16 weight copies the backward keeps, the head, the
  body models, the loss and the allocator's rounding.

The estimate then reads 14.9 GB at 896_L batch 2, remat none, against the
14.2 GB (13.24 GiB) the standard stream used.

The fit test keeps a 0.92 safety factor on the memory the card has free:
a wrong "fits" costs the user an OOM, a wrong "does not fit" 5-25 % of the
step time.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

# bytes per (token x embed-dim x layer) the backward keeps, per policy
_ACT_BYTES_PER_TOKEN_DIM = {"none": 41.5, "mlp": 25.5, "block": 0.2}
# fp32 weights, fp32 gradients, Adam's two fp32 moments
_BYTES_PER_PARAM = 4 + 4 + 4 + 4
# bf16 weight copies, head, body models, loss and allocator slack, lumped
_FIXED_BYTES = 0.99e9
_SAFETY = 0.92

# fastest first — the chooser returns the first level that fits
_POLICY_ORDER = ("none", "mlp", "block")


def approx_param_count(cfg) -> int:
    """Analytic parameter count (±5% is plenty for a memory estimate).

    Per ViT layer: qkv (3D²) + proj (D²) + fc1/fc2 (8D²) = 12D²; the HPH
    cross-attention stack, SMPL-X regression head, patch/camera embeddings
    and detection head add a config-dependent but small tail (~30M at
    D=1024 — reference model.py:352-593 scale).
    """
    v = cfg.vit
    vit = 12 * v.embed_dim * v.embed_dim * v.depth
    h = cfg.hph
    head = 12 * h.dim * h.dim * cfg.xat_depth + h.dim * cfg.token_dim
    embeds = v.embed_dim * (v.patch_size * v.patch_size * 3
                            + v.pos_embed_size * v.pos_embed_size)
    return int((vit + head + embeds) * 1.05)


def token_dims(cfg, batch_size: int) -> int:
    """batch x tokens x embed dim x depth of the ViT."""
    v = cfg.vit
    return batch_size * (cfg.num_patches + 1) * v.embed_dim * v.depth


def estimate_train_hbm_bytes(cfg, batch_size: int, policy: str) -> float:
    """Estimated peak device memory of one train step at the given remat
    level: ``policy`` is ``"none"`` (remat=False), ``"mlp"`` or ``"block"``."""
    return (approx_param_count(cfg) * _BYTES_PER_PARAM
            + _ACT_BYTES_PER_TOKEN_DIM[policy] * token_dims(cfg, batch_size)
            + _FIXED_BYTES)


def device_hbm_limit(device="cuda") -> float:
    """Bytes this process can still use on the CUDA card: free on the card
    (``torch.cuda.mem_get_info``) plus what its caching allocator holds
    unused. On the CPU, the host's physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return float(torch.cuda.mem_get_info(device)[0] + cached)
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def choose_remat(
    cfg,
    batch_size: int,
    hbm_limit_bytes: Optional[float] = None,
    policy: Optional[str] = None,
) -> Tuple[bool, str, dict]:
    """Pick the fastest remat level whose estimate fits the memory budget.

    Returns ``(remat, remat_policy, report)`` ready for ModelConfig.
    ``hbm_limit_bytes`` defaults to :func:`device_hbm_limit` of the CUDA card.
    ``policy`` restricts the choice to {"none", policy} (the user pinned a
    policy but left ``--remat auto`` to decide whether it is needed at all).
    When even "block" does not fit, block is returned anyway: the estimate
    is conservative and an OOM error names the real number.
    """
    limit = hbm_limit_bytes if hbm_limit_bytes else device_hbm_limit()
    budget = _SAFETY * limit
    order = _POLICY_ORDER if policy is None else ("none", policy)
    estimates = {p: estimate_train_hbm_bytes(cfg, batch_size, p) for p in order}
    chosen = order[-1]
    for p in order:
        if estimates[p] <= budget:
            chosen = p
            break
    report = {
        "hbm_limit_bytes": limit,
        "budget_bytes": budget,
        "estimates_gb": {p: round(e / 1e9, 2) for p, e in estimates.items()},
        "chosen": chosen,
    }
    return chosen != "none", ("mlp" if chosen == "none" else chosen), report


def resolve_remat_flags(
    remat_arg: str,
    policy_arg: Optional[str],
    cfg,
    batch_size: int,
    hbm_limit_bytes: Optional[float] = None,
) -> Tuple[bool, str, Optional[dict]]:
    """CLI-flag resolution for ``--remat {auto,0,1} --remat_policy {...}``.

    Returns ``(remat, remat_policy, report)``; ``report`` is None unless
    auto ran."""
    if remat_arg == "auto":
        return choose_remat(cfg, batch_size, hbm_limit_bytes=hbm_limit_bytes, policy=policy_arg)
    return bool(int(remat_arg)), policy_arg or "mlp", None
