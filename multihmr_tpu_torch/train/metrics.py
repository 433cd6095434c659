"""Training meters (``multihmr_tpu/train/metrics.py``, ``AverageMeter`` only).

A copy of the JAX package's pure-Python class; ``tests/test_torch_data.py``
holds it equal to the original."""

from __future__ import annotations


class AverageMeter:
    """Running average."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt[1:]}} ({self.avg:{self.fmt[1:]}})"
