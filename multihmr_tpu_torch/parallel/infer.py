"""Data-parallel inference inside one process (``multihmr_tpu/parallel/infer.py``).

The JAX package runs one ``jit`` program with the weights replicated and
the batch sharded over the mesh's ``data`` axis. Here the "mesh" is a list
of devices: :class:`DataParallel` keeps one replica of the weights on each
distinct device, splits a batch into ``n`` equal chunks in order, enqueues
each chunk's forward on its device (CUDA devices then run side by side),
and the results are put back together on the host in order. A list may
name a device twice: its chunks then run one after the other on the same
replica. Training and the sharded forward use the multi-process mesh of
parallel/sharding.py instead.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from multihmr_tpu_torch.utils.profiling import span


def _on(device: torch.device):
    """The device context a chunk's kernels launch in."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class DataParallel:
    """``model`` (a single-device ``MultiHMR``) replicated over ``devices``."""

    def __init__(self, model, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("data parallelism needs at least one device")
        self.replicas = {}
        for d in self.devices:
            if d not in self.replicas:
                self.replicas[d] = model.replica(d)

    def __len__(self) -> int:
        return len(self.devices)

    def chunks(self, *arrays):
        """(device, replica, chunk of each array) for each device in order:
        the arrays' leading dim cut into ``len(self)`` equal chunks."""
        n = len(self.devices)
        B = arrays[0].shape[0]
        if B % n:
            raise ValueError(f"batch of {B} does not split over {n} devices")
        b = B // n
        for i, d in enumerate(self.devices):
            yield d, self.replicas[d], [a[i * b:(i + 1) * b] for a in arrays]

    def start_persons(self, x: np.ndarray, K: np.ndarray, fields=None, prepare=None, **kw):
        """Enqueue each chunk's forward and its readback
        (``MultiHMR.start_persons``) on its device; returns the readbacks
        in order. ``prepare(x, K, device)`` moves a chunk to its device (and
        may normalise it); by default a plain copy."""
        if prepare is None:
            prepare = lambda x, K, d: (torch.as_tensor(x).to(d), torch.as_tensor(K).to(d))  # noqa: E731
        pending = []
        for d, model, (xc, Kc) in self.chunks(x, K):
            with _on(d):
                with span("upload"):
                    xd, Kd = prepare(xc, Kc, d)
                pending.append(model.start_persons(model.forward(xd, Kd, **kw), fields))
        return pending


def persons_in_order(pending) -> list:
    """The chunks' per-image person lists, concatenated in order."""
    return [p for r in pending for p in r.persons()]


def folder_inference(model, images: Sequence[np.ndarray], K: np.ndarray,
                     det_thresh: float = 0.3, nms_kernel_size: int = 3,
                     batch_size: Optional[int] = None, mesh=None,
                     fields: Optional[Sequence[str]] = None) -> List[list]:
    """Run ``model`` over a set of preprocessed ``[S, S, 3]`` images,
    data-parallel over the devices of ``mesh`` (a list of devices; default
    the model's own). ``K`` is shared ``[3, 3]`` or per image ``[N, 3, 3]``.
    Returns the per-image person lists. The images are padded to a full
    last batch (``batch_size``, default one image per device, a multiple of
    the device count) and the padding's outputs dropped. ``fields``
    restricts the readback (see ``MultiHMR.extract_persons``)."""
    devices = list(mesh) if mesh is not None else [model.body_model.v_template.device]
    dp = DataParallel(model, devices)
    if batch_size is None:
        batch_size = len(dp)
    if batch_size % len(dp):
        raise ValueError(f"batch_size {batch_size} must divide over {len(dp)} devices")
    K = np.asarray(K, np.float32)
    if K.ndim == 2:
        K = np.broadcast_to(K, (len(images), 3, 3))
    results: List[list] = []
    with torch.inference_mode():
        for start in range(0, len(images), batch_size):
            idxs = list(range(start, min(start + batch_size, len(images))))
            pad = [idxs[-1]] * (batch_size - len(idxs))
            with span("stack"):
                xb = np.stack([np.asarray(images[i], np.float32) for i in idxs + pad])
                Kb = np.stack([K[i] for i in idxs + pad])
            pending = dp.start_persons(xb, Kb, fields=list(fields) if fields else None,
                                       det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)
            results.extend(persons_in_order(pending)[:len(idxs)])
    return results
