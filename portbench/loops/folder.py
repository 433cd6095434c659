"""Offline inference over a folder of images in batches.

``parallel/infer.py::folder_inference(model, images, K, batch_size=...)``
over a pool of frames made from the seed and preprocessed at set-up
(contain-resized, padded and normalized; K of the configuration's field of
view), called over the whole pool again and again until the window closes.

Traffic parameters: ``frame_sizes``, ``per_size`` (the pool is their
product), ``batch``, ``check_images``, ``trace_at_s``, ``trace_s``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, judge
from portbench.loops import common
from portbench.trace import SubWindow, span


class State:
    pass


def setup(cell) -> State:
    from multihmr_tpu_torch.parallel.infer import folder_inference

    t, s = cell.traffic, State()
    s.run = folder_inference
    s.model = common.build_model(cell, bf16_backbone=True)
    S = cell.config["img_size"]
    frames = inputs.frames(t["frame_sizes"], t["per_size"], cell.seed, cell.device)
    s.images = [inputs.normalize(inputs.contain_pad(f, S)) for f in frames]
    s.K = inputs.camera_K(S, cell.config["fov"])
    s.kw = dict(det_thresh=cell.config["det_thresh"],
                nms_kernel_size=cell.config["nms_kernel_size"], batch_size=t["batch"])
    s.run(s.model, s.images[:t["batch"]], s.K, **s.kw)  # the batch's shapes
    common.sync(cell.device)
    return s


def window(cell, s: State) -> dict:
    from multihmr_tpu_torch.ops import cuda_lib

    kept, offer = common.sample(np.random.default_rng(cell.seed), cell.traffic["check_images"])
    sub = SubWindow(cell.trace, cell.traffic["trace_at_s"], cell.traffic["trace_s"])
    cuda_lib.reset_launches()
    calls, spans, persons_seen = 0, [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        with span("folder.folder_inference"):
            a = time.perf_counter()
            results = s.run(s.model, s.images, s.K, **s.kw)
            spans.append((a, time.perf_counter()))
        for i, persons in enumerate(results):
            offer((calls, i), (i, persons))
            persons_seen += len(persons)
        calls += 1
        sub.at(time.perf_counter() - t0)
    t_end = time.perf_counter()
    sub.close()
    s.kept = kept
    s.traced_units = sum(len(s.images) for a, b in spans if sub.active(a, b))
    n = calls * len(s.images)
    batches = calls * -(-len(s.images) // cell.traffic["batch"])
    return {"attempted": n, "failed": 0, "trace": sub.result(),
            "metrics": {"images_per_s": n / (t_end - t0)},
            "notes": {"K1 per batch": cuda_lib.LAUNCHES.get("flash_fwd_t", 0) / batches,
                      "K2 per batch": cuda_lib.LAUNCHES.get("layernorm_cm", 0) / batches,
                      "persons per image": persons_seen / max(n, 1)}}


def check(cell, s: State) -> dict:
    kept = s.kept
    del s.model
    torch.cuda.empty_cache() if cell.device.type == "cuda" else None
    ref = judge.reference(cell)
    numbers = judge.Tally()
    for _, (i, persons) in sorted(kept.items()):
        judge.judge_image(ref, s.images[i], s.K, persons, numbers)
    return numbers.numbers()


def control(cell, s: State) -> dict:
    """The control (``Reference(control=True)``) in the program's place on
    the images the window's check samples, judged the same way."""
    ctrl, ref = judge.reference(cell, control=True), judge.reference(cell)
    numbers = judge.Tally()
    for _, (i, _) in sorted(s.kept.items()):
        judge.judge_image(ref, s.images[i], s.K,
                          judge.control_persons(ctrl, s.images[i], s.K), numbers)
    return numbers.numbers()
