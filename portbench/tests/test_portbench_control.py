"""The control: the reference one precision step below the configuration
(fp8 ViT products, TF32 elsewhere; ``reference/precision.py``) in the
program's place must come out not correct under each cell's limits.

On a card this runs each cell at its own size on three seeds, the window
short (``calibrate.py`` gives the same readings with the program's beside
them). On the CPU, at the tiny size, the control must read further from the
reference than the program does."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEEDS = (2**31 + 201, 2**31 + 202, 2**31 + 203)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", tiny.workloads(held=False))
def test_control_fails_on_card(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.cell_from_manifest(tiny.manifest(), workload, seed, 3.0, False, "cuda")
    drv = harness.loop(cell)
    state = drv.setup(cell)
    drv.window(cell, state)
    ok, checks = harness.judged(drv.control(cell, state), cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", tiny.workloads())
def test_control_reads_further_on_cpu(workload):
    cell = tiny.cell(workload, seed=SEEDS[0])
    drv = harness.loop(cell)
    state = drv.setup(cell)
    drv.window(cell, state)
    pool = state.__dict__.copy()
    control = drv.control(cell, state)
    state.__dict__.update(pool)
    program = drv.check(cell, state)
    compared = [k for k in cell.limits if program.get(k, 0) > 0]
    assert compared
    assert sum(control[k] > program[k] for k in compared) > len(compared) / 2, (program, control)
