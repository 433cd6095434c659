"""Metrics logging — TensorBoard when available, JSONL always.

The reference logs scalars to TensorBoard SummaryWriter per run dir
(reference train.py:47-56,313-328,477-479). This logger mirrors that tag
layout (``loss/*``, ``workload/*``, ``{dataset}-{split}-{subsample}/{metric}``)
and additionally appends machine-readable JSONL so headless runs keep their
history without TensorBoard.

A copy of ``multihmr_tpu/utils/logging.py``, held equal to it by
``tests/test_torch_data.py``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, logdir: str, name: str = "run"):
        self.logdir = os.path.join(logdir, name)
        os.makedirs(self.logdir, exist_ok=True)
        self.jsonl = open(os.path.join(self.logdir, "metrics.jsonl"), "a")
        self._tb = None
        try:  # tensorboardX or torch tensorboard, if present
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(self.logdir)
        except ImportError:  # no tensorboard package: JSONL only
            self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self.jsonl.write(
            json.dumps({"t": time.time(), "tag": tag, "value": float(value), "step": step})
            + "\n"
        )
        self.jsonl.flush()

    def scalars(self, values: Dict[str, float], step: int, prefix: str = ""):
        for k, v in values.items():
            self.scalar(f"{prefix}{k}", v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self.jsonl.close()
