"""Set-up shared by the loops: the program's model on the card, seeded."""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs, weights


def tf32_off():
    # fp32 geometry, as the program's CLIs run it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(cell, bf16_backbone: bool):
    """The program's ``MultiHMR`` with the seeded weights and body model, as
    ``cli/demo.py`` sets it up (``bf16_backbone``: ``cast_backbone_bf16``
    after the load)."""
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    tf32_off()
    cfg = cell.model_config()
    net, _, _ = weights.load(MultiHMRNet, cfg, cell.config, cell.seed, cell.device)
    body = BodyModel.from_arrays(inputs.body_model(cell.config["body_model"], cell.seed),
                                 cell.device)
    model = MultiHMR(cfg, body, net=net.eval())
    if bf16_backbone:
        cast_backbone_bf16(model.net)
    return model


def sample(rng: np.random.Generator, k: int):
    """Reservoir sampling: ``offer(i, item)`` keeps a uniform sample of ``k``
    of the items offered, drawn from ``rng``."""
    kept, seen = {}, [0]

    def offer(key, item):
        n = seen[0]
        seen[0] += 1
        if n < k:
            kept[key] = item
        else:
            j = int(rng.integers(0, n + 1))
            if j < k:
                kept.pop(sorted(kept)[j])
                kept[key] = item
    return kept, offer


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
