"""Offline inference over a folder of images in batches, on DINOv2's ViT-g/14.

``loops/folder.py``'s traffic and window (imported, not changed) over the
program's ``MultiHMR`` of its port-only configuration ``multiHMR_896_G``
(``multihmr_tpu_torch/port_config.py``: 40 blocks of width 1,536, 24
heads, a fused SwiGLU FFN): ``parallel/infer.py::folder_inference(model,
images, K, batch_size=...)`` over a pool of frames made from the seed and
preprocessed at set-up, called over the whole pool again and again until
the window closes. The weights are ``weights_vitg``'s, the body model the
synthetic SMPL-X-sized one of ``inputs.body_model``, and the comparison
that decides ``correct`` is ``judge.py``'s with the plain reference
``reference/vitg.py`` in place of ``reference/model.py``.

Set-up also counts the forward kinematics' bone compositions over the
calls of the window, as ``loops/folder_anny.py`` does (its ``_counting``),
for ``fk_steps.infer``: 55 a call for SMPL-X.

A program without the configuration fails at set-up: the loop asks the
port's factory for it by name.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import inputs, judge, weights_vitg
from portbench.loops import common
from portbench.loops.folder import State, window  # noqa: F401
from portbench.loops.folder_anny import _counting
from portbench.reference.vitg import VitgReference

# the configuration file's ViT fields, compared with the port's config
VIT_FIELDS = ("embed_dim", "depth", "num_heads", "patch_size", "mlp_ratio", "ffn_layer")


def model_config(c: dict):
    """The port's configuration of the file's ``name``
    (``factory.smplx_config``), which must have the file's sizes."""
    from multihmr_tpu_torch.factory import smplx_config
    from multihmr_tpu_torch.port_config import ffn_hidden

    cfg = smplx_config(c["name"])
    vit = cfg.vit
    want = {k: c[k] for k in VIT_FIELDS}
    got = {k: getattr(vit, k, None) for k in VIT_FIELDS}
    same = {
        "backbone": c["backbone"], "img_size": c["img_size"],
        "camera_embedding_num_bands": c["camera_embedding_num_bands"],
        "camera_embedding_max_resolution": c["camera_embedding_max_resolution"],
        "fovn": c["fovn"], "xat_depth": c["xat_depth"], "xat_num_heads": c["xat_num_heads"],
        "num_betas": c["num_betas"], "nrot": c["nrot"], "max_people": c["max_people"],
        "compute_dtype": c["compute_dtype"], "param_dtype": c["param_dtype"],
    }
    if (got != want or ffn_hidden(vit) != c["ffn_hidden"] or cfg.hph.dim != c["hph_dim"]
            or {k: getattr(cfg, k) for k in same} != same):
        raise ValueError(f"configs/{c['name']}.json differs from the port's smplx_config: "
                         f"{dataclasses.asdict(cfg)}")
    return cfg


def build_model(cell):
    """The program's ``MultiHMR`` with the seeded weights and body model, the
    backbone cast to bf16 after the load as ``cli/demo.py`` does."""
    from multihmr_tpu_torch.bodymodel.core import BodyModel
    from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    common.tf32_off()
    cfg = model_config(cell.config)
    net = weights_vitg.load(MultiHMRNet, cfg, cell.config, cell.seed, cell.device)
    body = BodyModel.from_arrays(inputs.body_model(cell.config["body_model"], cell.seed),
                                 cell.device)
    model = MultiHMR(cfg, body, net=net.eval())
    cast_backbone_bf16(model.net)
    return model


def reference(cell, control: bool = False) -> VitgReference:
    """The plain reference on weights and a body model drawn anew from the
    seed (the shapes of the port's network, built on the meta device)."""
    from multihmr_tpu_torch.models.multihmr import MultiHMRNet

    shapes, norms = weights_vitg.layout(MultiHMRNet, model_config(cell.config))
    w = weights_vitg.draw(shapes, norms, cell.config, cell.seed, cell.device)
    body = inputs.body_model(cell.config["body_model"], cell.seed)
    return VitgReference(cell.config, w, body, cell.device, control=control)


def setup(cell) -> State:
    from multihmr_tpu_torch.parallel.infer import folder_inference

    t, s = cell.traffic, State()
    s.model = build_model(cell)
    S = cell.config["img_size"]
    frames = inputs.frames(t["frame_sizes"], t["per_size"], cell.seed, cell.device)
    s.images = [inputs.normalize(inputs.contain_pad(f, S)) for f in frames]
    s.K = inputs.camera_K(S, cell.config["fov"])
    s.kw = dict(det_thresh=cell.config["det_thresh"],
                nms_kernel_size=cell.config["nms_kernel_size"], batch_size=t["batch"])
    s.fk_steps, s.fk_batches = 0, 0
    s.run = _counting(folder_inference, s)
    s.run(s.model, s.images[:t["batch"]], s.K, **s.kw)  # the batch's shapes
    common.sync(cell.device)
    s.fk_steps, s.fk_batches = 0, 0
    return s


def check(cell, s: State) -> dict:
    kept = s.kept
    del s.model
    torch.cuda.empty_cache() if cell.device.type == "cuda" else None
    ref = reference(cell)
    numbers = judge.Tally()
    for _, (i, persons) in sorted(kept.items()):
        judge.judge_image(ref, s.images[i], s.K, persons, numbers)
    return numbers.numbers()


def control(cell, s: State) -> dict:
    """The control (``VitgReference(control=True)``) in the program's place
    on the images the window's check samples, judged the same way."""
    ctrl, ref = reference(cell, control=True), reference(cell)
    numbers = judge.Tally()
    for _, (i, _) in sorted(s.kept.items()):
        judge.judge_image(ref, s.images[i], s.K,
                          judge.control_persons(ctrl, s.images[i], s.K), numbers)
    return numbers.numbers()
