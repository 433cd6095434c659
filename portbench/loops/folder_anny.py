"""Offline inference over a folder of images in batches, for the Anny family.

``loops/folder.py``'s traffic and window (imported, not changed) over the
program's ``MultiHMRAnny``: ``parallel/infer.py::folder_inference(model,
images, K, batch_size=...)`` over a pool of frames made from the seed and
preprocessed at set-up, called over the whole pool again and again until
the window closes. K is the configuration's field of view, passed as the
demo passes it; the network's own ``K_regressed`` and ``fov`` come back
beside it. The body model is the synthetic Anny asset of
``weights_anny.asset``.

Set-up also counts the forward kinematics' bone compositions
(``bodymodel/core.py::FK``, where the program has it) over the calls of the
window, for ``fk_steps.infer``: ``State.fk_steps`` over
``State.fk_batches``.
"""

from __future__ import annotations

import torch

from portbench import inputs, judge, judge_anny, weights_anny
from portbench.loops import common
from portbench.loops.folder import State, window  # noqa: F401


def build_model(cell):
    """The program's ``MultiHMRAnny`` with the seeded weights and asset, the
    backbone cast to bf16 after the load as ``cli/demo.py`` does."""
    from multihmr_tpu_torch.bodymodel.anny import AnnyModel
    from multihmr_tpu_torch.models.multihmr_anny import MultiHMRAnny, MultiHMRAnnyNet
    from multihmr_tpu_torch.utils.precision import cast_backbone_bf16

    common.tf32_off()
    cfg = judge_anny.model_config(cell.config)
    net = weights_anny.load(MultiHMRAnnyNet, cfg, cell.config, cell.seed, cell.device)
    body = AnnyModel.from_arrays(weights_anny.asset(cell.config["body_model"], cell.seed),
                                 cell.device)
    model = MultiHMRAnny(cfg, body, net=net.eval())
    cast_backbone_bf16(model.net)
    return model


def _counting(run, s: State):
    """``run`` (``folder_inference``) adding the bone compositions and the
    batches of each call to ``s``."""
    from multihmr_tpu_torch.bodymodel import core

    fk = getattr(core, "FK", None)

    def call(model, images, K, **kw):
        before = fk["steps"] if fk is not None else 0
        out = run(model, images, K, **kw)
        if fk is not None:
            s.fk_steps += fk["steps"] - before
        s.fk_batches += -(-len(images) // kw["batch_size"])
        return out
    return call


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
    ref = judge_anny.reference(cell)
    numbers = judge.Tally()
    for _, (i, persons) in sorted(kept.items()):
        judge_anny.judge_image(ref, s.images[i], s.K, persons, numbers)
    return numbers.numbers()


def control(cell, s: State) -> dict:
    """The control (``AnnyReference(control=True)``) in the program's place
    on the images the window's check samples, judged the same way."""
    ctrl, ref = judge_anny.reference(cell, control=True), judge_anny.reference(cell)
    numbers = judge.Tally()
    for _, (i, _) in sorted(s.kept.items()):
        judge_anny.judge_image(ref, s.images[i], s.K,
                               judge_anny.control_persons(ctrl, s.images[i], s.K), numbers)
    return numbers.numbers()
