"""Model export: a ``torch.export`` serving artifact (``multihmr_tpu/io/export.py``).

The JAX package exports once and serves without the model code: a
``jax.export`` StableHLO program, its weights and a ``meta.json``. The port
does the same with ``torch.export``:

    model_dir/
      model.pt2   — torch.export.save of the serving module's ExportedProgram,
                    the weights inside as lifted parameters (the body model's
                    arrays as lifted constants)
      meta.json   — name, img_size, batch_size, det_thresh, nms_kernel_size,
                    max_people (the JAX keys), and device, tp_mode and the
                    count of each kernel operator in the graph

Notes:
  * the hand-written kernels are operators (``torch.ops.mhmr.flash_fwd_t``:
    K1, ``layernorm_cm``: K2, ``attention_qkv``: K5; ``ops/attention.py``,
    ``ops/norm.py``), so the graph holds them as nodes and runs the kernel
    on the card, the plain version on the CPU; the dispatcher picks by the
    tensors' device, as in the eager model. The export traces them through
    their fake implementations, on the model's own device;
  * the artifact is device-checked, as the JAX one is platform-checked: an
    artifact exported on the CPU holds CPU tensors and is refused on the
    card, and the other way round (:func:`load_exported` raises before it
    reads the program). Export on the device you deploy to;
  * the detection threshold and the NMS kernel are baked in at export time,
    as is the batch shape;
  * the program takes ``(x [B, S, S, 3] f32 normalized, K [B, 3, 3] f32)``
    and returns a flat dict of tensors (``Detections`` flattened to
    ``det_*`` keys). The JAX program takes the weights as an argument; this
    one carries them inside, and both put them on the device once, at load.

:func:`load_exported` imports torch and the kernels' operator registration
(``ops/``) and nothing of ``models/``, ``factory`` or ``bodymodel/``.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

# importing these registers the kernels' operators, which the saved graph names
from multihmr_tpu_torch.ops import attention, cuda_lib, norm  # noqa: F401

_MODEL_FILE = "model.pt2"
_META_FILE = "meta.json"
# the kernels' operators (torch.ops.mhmr.<name>): K1, K2, K5
KERNEL_OPS = ("flash_fwd_t", "layernorm_cm", "attention_qkv")


class ServingModule(nn.Module):
    """``(x, K) -> flat dict of tensors`` around ``model.forward``, the
    detection parameters fixed; ``net`` is the model's network, so that its
    weights are the module's parameters."""

    def __init__(self, model, det_thresh: float = 0.3, nms_kernel_size: int = 3):
        super().__init__()
        self.net = model.net
        self.model = model  # not a Module: its body model's tensors are constants
        self.det_thresh = det_thresh
        self.nms_kernel_size = nms_kernel_size

    def forward(self, x, K):
        out = dict(self.model.forward(x, K, det_thresh=self.det_thresh,
                                      nms_kernel_size=self.nms_kernel_size))
        det = out.pop("det")
        out["det_rows"] = det.rows
        out["det_cols"] = det.cols
        out["det_scores"] = det.scores
        out["det_valid"] = det.valid
        return out


def make_serving_fn(model, det_thresh: float = 0.3, nms_kernel_size: int = 3) -> ServingModule:
    """The serving module of ``model`` (``MultiHMR`` or ``MultiHMRAnny``):
    ``(x, K) -> flat dict``."""
    return ServingModule(model, det_thresh, nms_kernel_size)


def kernel_op_counts(graph) -> dict:
    """``{operator name: nodes}`` of the kernels' operators in an FX graph,
    every name of :data:`KERNEL_OPS` present (0 when absent)."""
    counts = dict.fromkeys(KERNEL_OPS, 0)
    for node in graph.nodes:
        target = node.target
        if (node.op == "call_function" and isinstance(target, torch._ops.OpOverload)
                and target.namespace == cuda_lib.OP_NAMESPACE):
            counts[target._opname] += 1
    return counts


def _backbone(net):
    return net.backbone if hasattr(net, "backbone") else net.encoder.backbone


def export_program(model, batch_size: int = 1, det_thresh: float = 0.3,
                   nms_kernel_size: int = 3, name: str = "multihmr"):
    """(``ExportedProgram``, meta) of ``model``'s serving module, traced on
    the device its weights are on, without recording a graph."""
    fn = make_serving_fn(model, det_thresh, nms_kernel_size).eval()
    device = next(model.net.parameters()).device
    S = model.cfg.img_size
    x = torch.zeros((batch_size, S, S, 3), device=device)
    K = torch.eye(3, device=device).expand(batch_size, 3, 3).contiguous()
    with torch.no_grad():
        program = torch.export.export(fn, (x, K), strict=False)
    # else the traced batch rides along in model.pt2 and onto the device at
    # every load (41 MiB at 672 px, batch 8)
    program.example_inputs = None
    meta = {
        "name": name,
        "img_size": S,
        "batch_size": batch_size,
        "det_thresh": det_thresh,
        "nms_kernel_size": nms_kernel_size,
        "max_people": int(model.cfg.max_people),
        "device": device.type,
        "tp_mode": "heads" if _backbone(model.net).transposed else "ring",
        "kernel_ops": kernel_op_counts(program.graph),
    }
    return program, meta


def save_exported(program, meta: dict, out_dir: str) -> str:
    """Write ``model.pt2`` and ``meta.json`` into ``out_dir`` (created)."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _MODEL_FILE))
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def export_model(model, out_dir: str, batch_size: int = 1, det_thresh: float = 0.3,
                 nms_kernel_size: int = 3, name: str = "multihmr") -> str:
    """Export ``model`` with its weights into ``out_dir`` (created): the
    JAX ``export_model``'s contract, the weights inside. Returns
    ``out_dir``."""
    program, meta = export_program(model, batch_size, det_thresh, nms_kernel_size, name)
    return save_exported(program, meta, out_dir)


class ExportedModel:
    """A loaded serving artifact: ``__call__(x, K) -> dict`` of tensors on
    :attr:`device`. Loads with no model code: torch and the kernels'
    operators only. The weights sit on the device once, inside
    :attr:`module`."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self.module = program.module()
        self.meta = meta
        self.device = device

    def __call__(self, x, K) -> dict:
        with torch.inference_mode():
            return dict(self.module(torch.as_tensor(x, device=self.device),
                                    torch.as_tensor(K, device=self.device)))

    @property
    def batch_size(self) -> int:
        return int(self.meta["batch_size"])

    @property
    def img_size(self) -> int:
        return int(self.meta["img_size"])


def read_meta(model_dir: str) -> dict:
    """The ``meta.json`` of an :func:`export_model` artifact directory."""
    with open(os.path.join(model_dir, _META_FILE)) as f:
        return json.load(f)


def load_exported(model_dir: str, device="cuda") -> ExportedModel:
    """Load an :func:`export_model` artifact directory to run on ``device``.
    Raises ``ValueError`` when the artifact was exported on another device
    type, before anything is read onto a device."""
    meta = read_meta(model_dir)
    device = torch.device(device)
    if meta["device"] != device.type:
        raise ValueError(
            f"{model_dir} was exported on {meta['device']!r} and is asked to run on "
            f"{device.type!r}: export it again on {device.type!r} "
            "(python -m multihmr_tpu_torch.tools.export_model --device ...)")
    program = torch.export.load(os.path.join(model_dir, _MODEL_FILE))
    return ExportedModel(program, meta, device)


def as_model_forward(loaded: ExportedModel):
    """``loaded`` as a ``model.forward``-shaped ``(x, K) -> out``, the
    ``det_*`` tensors re-bundled into a
    :class:`~multihmr_tpu_torch.ops.detection.Detections`, so that the
    artifact drives the same serving and extraction stack as a live model
    (``serve.build_batched_infer(..., forward_fn=as_model_forward(m))``). Its
    ``device`` attribute is the artifact's."""
    from multihmr_tpu_torch.ops.detection import Detections

    def forward(x, K):
        out = loaded(x, K)
        out["det"] = Detections(out.pop("det_rows"), out.pop("det_cols"),
                                out.pop("det_scores"), out.pop("det_valid"))
        return out

    forward.device = loaded.device
    return forward
