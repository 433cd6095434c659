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

:func:`folder_inference` keeps one batch in flight ahead of the host: it
stages and enqueues batch i+1 before it reads batch i back. On a CUDA
device the batch is staged in pinned host memory and copied on a copy
stream of its own, so that the copy runs under the previous batch's
forward; :data:`PIPELINE` counts the batches and those run ahead.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from multihmr_tpu_torch.utils.profiling import span


#: ``folder_inference``'s batches, and of them those whose forward was
#: enqueued while an earlier batch of the same call was not yet read back
PIPELINE = {"batches": 0, "ahead": 0}

_COPY_STREAMS: dict = {}  # device -> its host-to-device copy stream


def reset_pipeline() -> None:
    PIPELINE.update(batches=0, ahead=0)


def _on(device: torch.device):
    """The device context a chunk's kernels launch in."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _upload(x: torch.Tensor, K: torch.Tensor, device: torch.device):
    """``prepare`` for ``folder_inference``'s staged batch. On a CUDA device the
    copies are enqueued on the device's copy stream (the sources are
    pinned, so they do not block the host), the current stream waits for
    them, and the device tensors are marked in use by it, so that their
    blocks are not reused before its forward has read them."""
    if device.type != "cuda":
        return x.to(device), K.to(device)
    copy = _COPY_STREAMS.get(device)
    if copy is None:
        copy = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    with torch.cuda.stream(copy):
        xd, Kd = x.to(device, non_blocking=True), K.to(device, non_blocking=True)
    compute.wait_stream(copy)
    xd.record_stream(compute)
    Kd.record_stream(compute)
    return xd, Kd


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
    restricts the readback (see ``MultiHMR.extract_persons``).

    Each batch is enqueued (staged, uploaded, its forward and readback
    copies launched) before the previous one is read back, so the host's
    work for a batch runs under the previous batch's forward."""
    devices = list(mesh) if mesh is not None else [model.body_model.v_template.device]
    dp = DataParallel(model, devices)
    if batch_size is None:
        batch_size = len(dp)
    if batch_size % len(dp):
        raise ValueError(f"batch_size {batch_size} must divide over {len(dp)} devices")
    K = np.asarray(K, np.float32)
    if K.ndim == 2:
        K = np.broadcast_to(K, (len(images), 3, 3))
    pin = any(d.type == "cuda" for d in dp.devices)
    fields = list(fields) if fields else None
    results: List[list] = []
    unread = None  # (readbacks, images) of the batch enqueued last
    with torch.inference_mode():
        for start in range(0, len(images), batch_size):
            idxs = list(range(start, min(start + batch_size, len(images))))
            pad = [idxs[-1]] * (batch_size - len(idxs))
            # torch owns the staging buffers, so the caching host allocator
            # holds a pinned block back until the copies that read it have run
            xb = torch.empty((batch_size, *np.shape(images[0])), dtype=torch.float32,
                             pin_memory=pin)
            Kb = torch.empty((batch_size, 3, 3), dtype=torch.float32, pin_memory=pin)
            xn, Kn = xb.numpy(), Kb.numpy()
            with span("stack"):
                np.stack([np.asarray(images[i], np.float32) for i in idxs + pad], out=xn)
                Kn[:] = K[idxs + pad]
            pending = dp.start_persons(xb, Kb, fields=fields, prepare=_upload,
                                       det_thresh=det_thresh, nms_kernel_size=nms_kernel_size)
            del xb, Kb, xn, Kn  # their pinned blocks are free for the next batch once copied
            PIPELINE["batches"] += 1
            if unread is not None:
                PIPELINE["ahead"] += 1
                results.extend(persons_in_order(unread[0])[:unread[1]])
            unread = pending, len(idxs)
        if unread is not None:
            results.extend(persons_in_order(unread[0])[:unread[1]])
    return results
