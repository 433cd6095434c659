"""A run whose timed path is broken underneath comes out not correct: an
answer altered where it is produced or with persons dropped (every cell
that answers images), a step that leaves the state unchanged and a step
over half the batch (the training cell). The runs are the CPU's tiny cells with the committed
limits."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

INFERENCE = [w for w in tiny.workloads() if not w.startswith("train")]


def _alter_first_person(monkeypatch):
    from multihmr_tpu_torch.models import multihmr

    sound = multihmr.persons_from_host

    def altered(host):
        persons = sound(host)
        for image in persons:
            if image:
                image[0]["transl"] = image[0]["transl"] + 0.5
        return persons
    monkeypatch.setattr(multihmr, "persons_from_host", altered)


@pytest.mark.parametrize("workload", INFERENCE)
def test_sound_run_is_correct(workload):
    assert harness.run(tiny.cell(workload), 0.0)["correct"]


@pytest.mark.parametrize("workload", INFERENCE)
def test_altered_answer_fails(workload, monkeypatch):
    _alter_first_person(monkeypatch)
    assert not harness.run(tiny.cell(workload), 0.0)["correct"]


@pytest.mark.parametrize("keep", [0, 1], ids=["nobody", "one_person"])
def test_dropped_persons_fail(keep, monkeypatch):
    """An answer that lists no person, or only its first: the numbers of
    the head are then missing, or the reference's head on the one cell
    departs from what the program computed with the others beside it."""
    from multihmr_tpu_torch.models import multihmr

    sound = multihmr.persons_from_host
    monkeypatch.setattr(multihmr, "persons_from_host",
                        lambda host: [image[:keep] for image in sound(host)])
    result = harness.run(tiny.cell("folder_896L_b8"), 0.0)
    assert not result["correct"], result["checks"]


def test_unchanged_state_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not harness.run(tiny.cell("train_896L_b8"), 0.0)["correct"]


def test_half_batch_fails(monkeypatch):
    from multihmr_tpu_torch.train import trainer

    sound = trainer.to_device

    def half(batch, device):
        return {k: v[: v.shape[0] // 2] for k, v in sound(batch, device).items()}
    monkeypatch.setattr(trainer, "to_device", half)
    assert not harness.run(tiny.cell("train_896L_b8"), 0.0)["correct"]


def test_sound_train_is_correct():
    assert harness.run(tiny.cell("train_896L_b8"), 0.0)["correct"]
