"""The port's ring and head-parallel attention
(``multihmr_tpu_torch/parallel/ring_attention.py``) against the JAX
package's on the same inputs: the cases of tests/test_ring_attention.py.

The port's side runs as one world of 4 spawned gloo ranks
(tests/torch_parallel_ranks.py::ring_world): a ring of 4 on the model axis,
and a (data 2, model 2) mesh for the dispatch; the JAX side runs here on 4
of conftest's 8 virtual CPU devices at the same mesh shapes. Inputs are
seeded numpy arrays in fp32. Tolerances are the JAX tests': the outputs
2e-5 abs, the gradients 3e-5 abs.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multihmr_tpu.ops.attention import mha_reference
from multihmr_tpu.parallel import make_mesh as jmake_mesh
from multihmr_tpu_torch.parallel.launch import Ranks
from tests import torch_parallel_ranks as ranks
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

# the module (the package re-exports its function of the same name)
jra = importlib.import_module("multihmr_tpu.parallel.ring_attention")
ATOL, GRAD_ATOL = 2e-5, 3e-5
SHAPES = {"ring64": (1, 2, 64, 16), "ring32": (2, 1, 32, 8), "heads": (1, 8, 24, 16),
          "padded": (2, 2, 65, 16), "grad": (1, 2, 13, 8), "dispatch": (4, 4, 17, 8)}


def _jax_side(inp):
    ring = jmake_mesh(4, model_parallel=4)
    a = {k: [jnp.asarray(t) for t in v] for k, v in inp.items()}
    out = {}
    with ring:
        out["ring64"] = jra.ring_attention(*a["ring64"], ring, axis="model")
        out["ring32"] = jax.jit(lambda q, k, v: jra.ring_attention(q, k, v, ring))(*a["ring32"])
        out["heads"] = jra.head_parallel_attention(*a["heads"], ring)
        out["padded"] = jax.jit(lambda q, k, v: jra.sequence_parallel_attention(
            q, k, v, ring))(*a["padded"])
        qt, kt, vt = (t.swapaxes(-1, -2) for t in a["heads"])
        out["t_heads"] = jra.mesh_attention_t(qt, kt, vt, ring, "heads")
        out["t_ring"] = jra.mesh_attention_t(qt, kt, vt, ring, "ring")
        out["merged_ring"] = jra.mesh_attention_merged(*a["heads"], ring, "ring")

    def f_ring(q, k, v):
        with ring:
            return jnp.sum(jra.sequence_parallel_attention(q, k, v, ring) ** 2)

    out["grad"] = jax.grad(f_ring, argnums=(0, 1, 2))(*a["grad"])
    q, k, v = a["dispatch"]
    out["dispatch_none"] = jra.mesh_attention(q, k, v, None)
    out["dispatch_trivial"] = jra.mesh_attention(q, k, v, jmake_mesh(4, model_parallel=1))
    mesh = jmake_mesh(4, model_parallel=2)
    with mesh:
        for mode in ("heads", "ring"):
            out[f"dispatch_{mode}"] = jax.jit(
                lambda q, k, v, mode=mode: jra.mesh_attention(q, k, v, mesh, mode=mode))(q, k, v)
    try:
        jra.mesh_attention(q[:, :3], k[:, :3], v[:, :3], mesh, "heads")
    except AssertionError as e:
        out["odd_heads"] = str(e)
    return jax.tree_util.tree_map(lambda t: np.asarray(t, np.float64)
                                  if not isinstance(t, str) else t, out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the port ranks' results, the JAX results, the inputs)."""
    rng = np.random.default_rng(0)
    inp = {k: [rng.normal(size=s).astype(np.float32) for _ in range(3)]
           for k, s in SHAPES.items()}
    path = tmp_path_factory.mktemp("ring") / "inputs.pt"
    torch.save(inp, path)
    started = Ranks(ranks.ring_world, 4, (str(path),))
    jax_out = _jax_side(inp)  # meanwhile
    return started.results(), jax_out, inp


def _ref(inp, key):
    return np.asarray(mha_reference(*(jnp.asarray(t) for t in inp[key])), np.float64)


def _ring_out(res, key):
    """The ring's output shards (rank r holds tokens r·N/4...) in order."""
    return np.concatenate([r[key] for r in res], axis=2)


def test_ring_attention_matches_reference(world):
    res, jax_out, inp = world
    got = _ring_out(res, "ring64")
    np.testing.assert_allclose(got, jax_out["ring64"], atol=ATOL)
    np.testing.assert_allclose(got, _ref(inp, "ring64"), atol=ATOL)


def test_ring_attention_batched(world):
    """Batch 2 and one head (the JAX test's ring under jit)."""
    res, jax_out, inp = world
    got = _ring_out(res, "ring32")
    np.testing.assert_allclose(got, jax_out["ring32"], atol=ATOL)
    np.testing.assert_allclose(got, _ref(inp, "ring32"), atol=ATOL)


def test_head_parallel_attention_matches(world):
    """8 heads over 4 ranks, gathered back on every rank."""
    res, jax_out, inp = world
    for r in res:
        np.testing.assert_allclose(r["heads"], jax_out["heads"], atol=ATOL)
        np.testing.assert_allclose(r["heads"], _ref(inp, "heads"), atol=ATOL)


def test_sequence_parallel_attention_padded(world):
    """N = 65 over 4 ranks pads to 68: the pad keys are masked."""
    res, jax_out, inp = world
    for r in res:
        assert r["padded"].shape == (2, 2, 65, 16)
        np.testing.assert_allclose(r["padded"], jax_out["padded"], atol=ATOL)
        np.testing.assert_allclose(r["padded"], _ref(inp, "padded"), atol=ATOL)


def test_sequence_parallel_attention_grad(world):
    """The ring (shifts both ways, the online combine, the pad mask) is
    differentiable: d sum(out^2) / d(q, k, v) at N = 13 over 4 ranks."""
    res, jax_out, _ = world
    for r in res:
        for got, want in zip(r["grad"], jax_out["grad"]):
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_mesh_attention_dispatch(world):
    """No mesh and a trivial model axis take the single-device path; on
    data 2 x model 2 each data rank's slice goes through heads or ring."""
    res, jax_out, inp = world
    ref = _ref(inp, "dispatch")
    for r in res:
        for key in ("dispatch_none", "dispatch_trivial"):
            np.testing.assert_allclose(r[key], jax_out[key], atol=ATOL)
            np.testing.assert_allclose(r[key], ref, atol=ATOL)
    for mode in ("heads", "ring"):
        by_data = {r["dispatch_data"]: r[f"dispatch_{mode}"] for r in res}
        got = np.concatenate([by_data[0], by_data[1]])
        np.testing.assert_allclose(got, jax_out[f"dispatch_{mode}"], atol=ATOL)
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_mesh_attention_t_and_merged(world):
    """The channels-major entry on heads and ring, and the heads-merged one."""
    res, jax_out, _ = world
    for r in res:
        for key in ("t_heads", "t_ring", "merged_ring"):
            np.testing.assert_allclose(r[key], jax_out[key], atol=ATOL, err_msg=key)


def test_mesh_attention_rejects_odd_heads(world):
    """3 heads over a model axis of 2: the JAX assertion's message, raised."""
    res, jax_out, _ = world
    assert jax_out["odd_heads"] == "num_heads=3 not divisible by mesh axis 'model'=2"
    assert all(r["odd_heads"] == jax_out["odd_heads"] for r in res)
