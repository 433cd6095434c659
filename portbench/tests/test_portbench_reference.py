"""The plain reference against the port, both in float32 at a tiny size:
the forward's detections and every output, the loss, and each leaf's
gradient and Adam update of a training step."""

import statistics

import numpy as np
import pytest
import torch

from portbench import inputs, judge
from portbench.loops import common, train
from portbench.reference import train as ref_train
from portbench.tests import tiny


def fp32_cell(workload):
    c = tiny.cell(workload)
    c.config = dict(c.config, compute_dtype="float32")
    return c


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_forward_matches_port(frame):
    cell = fp32_cell("folder_896L_b8")
    model = common.build_model(cell, bf16_backbone=False)
    ref = judge.reference(cell)
    S = cell.config["img_size"]
    f = inputs.frames(tiny.FRAMES, 2, cell.seed, "cpu")[frame]
    x, K = inputs.normalize(inputs.contain_pad(f, S)), inputs.camera_K(S, 60)
    with torch.no_grad():
        out = model.forward(torch.tensor(x)[None], torch.tensor(K)[None])
        feats = ref.features(torch.tensor(x), torch.tensor(K))
    valid = out["det"].valid[0] > 0
    rows, cols = ref.detect(feats["scores"])
    assert valid.sum() > 0
    assert torch.equal(rows, out["det"].rows[0][valid])
    assert torch.equal(cols, out["det"].cols[0][valid])
    torch.testing.assert_close(out["scores"][0], feats["scores"], rtol=0, atol=1e-5)
    with torch.no_grad():
        r = ref.head(feats, rows, cols, torch.tensor(K))
    for key in ("loc", "dist", "rotmat", "shape", "expression", "transl", "transl_pelvis",
                "v3d", "j3d", "j2d"):
        a, b = out[key][0][valid], r[key]
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-4 * scale, key


def test_judge_reads_zero_on_the_reference_itself():
    cell = fp32_cell("folder_896L_b8")
    ref = judge.reference(cell)
    S = cell.config["img_size"]
    f = inputs.frames(tiny.FRAMES, 1, cell.seed, "cpu")[0]
    x, K = inputs.normalize(inputs.contain_pad(f, S)), inputs.camera_K(S, 60)
    tally = judge.Tally()
    judge.judge_image(ref, x, K, judge.control_persons(ref, x, K), tally)
    numbers = tally.numbers()
    assert numbers["select_gap"] == 0 and numbers["persons_err"] == 0
    assert max(numbers.values()) < 1e-5


def test_train_step_matches_port():
    cell = fp32_cell("train_896L_b8")
    cell.traffic = dict(cell.traffic, checked_steps=2)
    s = train.setup(cell)
    prog = {"losses": s.losses, "terms": s.terms, "grad1": s.grad1, "delta": s.delta}
    train._free(cell, s)
    ref = ref_train.steps(judge.reference(cell), s.pool[:2], cell.traffic["lr"], 2)
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-4)
    med = statistics.median(ref["grad1"].values())
    for k, g in ref["grad1"].items():
        assert abs(prog["grad1"][k] - g) <= 1e-3 * max(g, med), k
    gaps = train.compare(prog, ref)
    assert gaps["change_gap"] < 1e-2


def test_control_departs():
    """The control (one precision step down) reads far from the reference."""
    cell = tiny.cell("folder_896L_b8")
    ref, ctrl = judge.reference(cell), judge.reference(cell, control=True)
    S = cell.config["img_size"]
    f = inputs.frames(tiny.FRAMES, 1, cell.seed, "cpu")[0]
    x = torch.tensor(inputs.normalize(inputs.contain_pad(f, S)))
    with torch.no_grad():
        a, b = ref.vit(x), ctrl.vit(x)
    assert float((a - b).abs().max()) > 1e-2 * float(a.abs().max())
