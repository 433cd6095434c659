"""Gradient NaN-safety of the port's rotation ops at degenerate inputs: the
three cases of tests/test_grad_safety.py, plus a loss with a random linear
read-out, whose gradient is not zero there."""

import numpy as np
import pytest
import torch

from multihmr_tpu_torch.ops.rotations import rot6d_to_rotmat, rotmat_to_rotvec, rotvec_to_rotmat


def _losses(out):
    w = torch.from_numpy(np.random.default_rng(0).normal(size=out.shape).astype(np.float32))
    return [(out ** 2).sum(), (out * w).sum()]


@pytest.mark.parametrize("which", [0, 1])
def test_rot6d_grad_finite_at_degenerate_inputs(which):
    # collinear a1/a2 (the identity-derived hand-joint init layout), zero, identity
    xs = torch.tensor([[1, 0, 0, 1, 0, 0], [0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 1, 0]],
                      dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(_losses(rot6d_to_rotmat(xs))[which], xs)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("which", [0, 1])
def test_rotvec_grad_finite_at_zero(which):
    rv = torch.zeros((3, 3), requires_grad=True)
    (g,) = torch.autograd.grad(_losses(rotvec_to_rotmat(rv))[which], rv)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("which", [0, 1])
def test_rotmat_to_rotvec_grad_finite_at_identity(which):
    R = torch.eye(3).expand(2, 3, 3).clone().requires_grad_()
    (g,) = torch.autograd.grad(_losses(rotmat_to_rotvec(R))[which], R)
    assert torch.isfinite(g).all()
