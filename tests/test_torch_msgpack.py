"""The JAX package's own checkpoints in the port: ``io/flax_msgpack.py``
(flax msgpack without flax or msgpack) against ``msgpack.unpackb`` and
``flax.serialization``, and ``io/checkpoint.py::load_jax_checkpoint`` on
files the JAX package's ``save_checkpoint`` writes, for the tiny slice of
tests/test_torch_model.py: the state dict bitwise equal to ``params_from_jax``
of the same params, and the port's forward within that test's "tempered"
fp32 tolerances of the JAX forward. Also the package's writer
(``flax_msgpack.dump_parts``, which chip_smoke.py phase 20 (c) uses) byte
for byte against ``flax.serialization.to_bytes``."""

import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.io.checkpoint import save_checkpoint
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu.utils.precision import cast_backbone_bf16
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.io import flax_msgpack
from multihmr_tpu_torch.io.checkpoint import load_jax_checkpoint
from multihmr_tpu_torch.io.convert import params_from_jax
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from tests.test_torch_model import TOLS, _rel_err, _tiny_cfg
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)


def _mixed_tree():
    """Every type flax writes into a parameter file, and a few more."""
    return {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "nested": {"f16": np.linspace(-1, 1, 5).astype(np.float16),
                   "i32": np.arange(-3, 3, dtype=np.int32),
                   "i64": np.array([2**40, -2**40], np.int64),
                   "u8": np.arange(7, dtype=np.uint8), "empty": np.zeros((0, 3), np.float32)},
        "bool": np.array([True, False, True]),
        "bf16": jnp.asarray([1.5, -2.0, 3.25, 1e-3], jnp.bfloat16),
        "scalar": np.float32(2.5),
        "scalar_i": np.int64(-7),
        "listed": [np.ones((2,), np.float32), np.zeros((1, 1), np.int32)],  # → "0", "1"
        "tuple": (1, -5, 300, -40000, 2**40, 127, 128, -33, -129),
        "text": "x" * 40, "long_text": "y" * 300, "none": None, "pi": 3.25, "yes": True,
        "raw": b"\x00\x01\x02",
        "many": {f"k{i}": i for i in range(20)},
    }


def _equal(got, want, path=""):
    """``got`` (the port's decode) against flax's or msgpack's; bf16 by bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        want = np.asarray(want)
        assert want.dtype.name == "bfloat16" and tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_decoder_matches_flax_and_msgpack():
    data = serialization.to_bytes(_mixed_tree())
    got = flax_msgpack.loads(data)
    _equal(got, serialization.msgpack_restore(data))
    # msgpack itself, with flax's ext hook for the arrays
    _equal(got, msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False))
    # and flax's typed restore into the tree's own structure
    target = _mixed_tree()
    restored = serialization.from_bytes(target, data)
    assert list(got["listed"]) == ["0", "1"] and isinstance(restored["listed"], list)
    for i, arr in enumerate(restored["listed"]):
        _equal(got["listed"][str(i)], arr)
    _equal(got["bf16"], restored["bf16"])
    assert got["scalar"] == restored["scalar"] and isinstance(got["scalar"], np.float32)
    # arrays are views of the buffer, not copies
    buf = bytearray(data)
    view = flax_msgpack.loads(buf)["f32"]
    assert not view.flags.owndata and np.shares_memory(view, np.frombuffer(buf, np.uint8))


def test_decoder_restores_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(10, 10),
            "bf": jnp.arange(70, dtype=jnp.bfloat16).reshape(7, 10),
            "small": np.ones(3, np.float32)}
    data = serialization.to_bytes(tree)
    raw = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack, raw=False)
    assert raw["big"]["__msgpack_chunked_array__"] is True and len(raw["big"]["chunks"]) == 7
    got = flax_msgpack.loads(data)
    _equal(got, serialization.msgpack_restore(data))
    assert got["big"].shape == (10, 10) and tuple(got["bf"].shape) == (7, 10)


@pytest.mark.parametrize("data,match", [
    (msgpack.packb({"x": msgpack.ExtType(2, b"\x92\x01\x02")}), "ext type 2"),
    (msgpack.packb({"x": msgpack.ExtType(5, b"ab")}), "ext type 5"),
    (serialization.to_bytes({"x": np.zeros(2, np.float64)}), "dtype 'float64'"),
    (serialization.to_bytes({"x": np.zeros(4, np.float32)})[:-3], "truncated"),
    (b"\x80\x80", "bytes after the value"),
    (b"\xc1", "type byte 0xc1"),
])
def test_decoder_refuses(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(data)


def test_chip_smoke_writer_matches_flax(jax_params):
    """The package's writer (chip_smoke.py phase 20's) makes the bytes flax
    makes, on the mixed tree and on a JAX model's parameters (the reader on
    those bytes: test_decoder_matches_flax)."""
    for tree in (_mixed_tree(), jax.device_get(jax_params[1])):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        assert b"".join(flax_msgpack.dump_parts(tree)) == serialization.to_bytes(tree)


@pytest.fixture(scope="module")
def jax_params():
    cfg = _tiny_cfg()
    jbm = jsynthetic()
    names = [f"j{i}" for i in range(jbm.num_output_joints)]
    jm = JMultiHMR(cfg, jbm, person_center_joint_names=names)
    return cfg, jm.init_params(jax.random.PRNGKey(3)), jm, names


def test_load_jax_checkpoint_bitwise(jax_params, tmp_path):
    """JAX save_checkpoint → load_jax_checkpoint: bitwise params_from_jax of
    the same params, and the metadata of its .json."""
    cfg, params, _, _ = jax_params
    path = save_checkpoint(str(tmp_path), params, 7, cfg)
    assert path.endswith("ckpt_000007.msgpack")
    sd, meta = load_jax_checkpoint(path, cfg)
    want = params_from_jax(jax.device_get(params), cfg)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], want[k]), k
    assert meta["epoch"] == 7 and meta["config"]["img_size"] == 56
    # bf16 leaves (the JAX package's inference cast) arrive as their fp32 values
    path = save_checkpoint(str(tmp_path / "bf16"), cast_backbone_bf16(params), 0, cfg)
    sd16, _ = load_jax_checkpoint(path, cfg)
    w16 = jax.device_get(cast_backbone_bf16(params))
    qkv = np.asarray(w16["params"]["backbone"]["blocks"]["block"]["attn"]["qkv"]["kernel"])
    assert qkv.dtype.name == "bfloat16"
    np.testing.assert_array_equal(sd16["backbone.blocks.1.attn.qkv.weight"].numpy(),
                                  qkv[1].astype(np.float32).T)
    assert torch.equal(sd16["x_attention_head.deccam.weight"], want["x_attention_head.deccam.weight"])


def test_loaded_forward_matches_jax(jax_params, tmp_path, rng):
    """The port's slice from the JAX file against the JAX forward of the same
    params, within tests/test_torch_model.py's "tempered" fp32 tolerances
    (flax's initializers scale by fan-in as "tempered" does). Measured:
    rotvec 1.5e-5, shape and expression 1.1e-6, the rest <= 2.5e-7."""
    cfg, params, jm, names = jax_params
    sd, _ = load_jax_checkpoint(save_checkpoint(str(tmp_path), params, 0, cfg), cfg)
    net = MultiHMRNet(cfg)
    net.load_state_dict(sd, strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net,
                  person_center_joint_names=names)
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]] * 2, np.float32)
    a = jax.jit(lambda p, x, K: jm.forward(p, x, K, det_thresh=0.0, batch_mode="fused"))(
        params, x, K)
    with torch.inference_mode():
        b = tm.forward(torch.from_numpy(x), torch.from_numpy(K), det_thresh=0.0)
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(getattr(b["det"], f).numpy(), np.asarray(getattr(a["det"], f)))
    for k, tol in TOLS["tempered"].items():
        assert _rel_err(a[k], b[k].numpy()) <= tol, k


def _rewrite(path, edit):
    tree = jax.tree_util.tree_map(np.asarray, serialization.msgpack_restore(open(path, "rb").read()))
    edit(tree["params"])
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))


@pytest.mark.parametrize("fault,error,match", [
    ("missing", KeyError, "port keys not filled.*mlp_offset"),
    ("extra", KeyError, "no port key.*stray"),
    ("shape", ValueError, "backbone.cls_token: JAX gives"),
    ("not_a_tree", ValueError, "not ndarray"),
])
def test_load_jax_checkpoint_strict(jax_params, tmp_path, fault, error, match):
    cfg, params, _, _ = jax_params
    path = save_checkpoint(str(tmp_path), params, 0, cfg)
    if fault == "missing":
        _rewrite(path, lambda p: p.pop("mlp_offset"))
    elif fault == "extra":
        _rewrite(path, lambda p: p.update(stray={"kernel": np.zeros((2, 2), np.float32)}))
    elif fault == "shape":
        _rewrite(path, lambda p: p["backbone"].update(cls_token=np.zeros((1, 2, 32), np.float32)))
    else:
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(np.zeros(3, np.float32)))
    with pytest.raises(error, match=match):
        load_jax_checkpoint(path, cfg)
    assert json.load(open(os.path.join(tmp_path, "ckpt_000000.json")))["epoch"] == 0
