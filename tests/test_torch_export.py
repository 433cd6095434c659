"""The port's model export (``multihmr_tpu_torch/io/export.py``) on the CPU.

The tiny configurations of tests/test_torch_model.py (``TinyConfig``: ViT 32
wide, 2 deep, 56 x 56, K = 4 slots, fp32) and tests/test_torch_anny.py
(the tiny Anny model), with the "tempered" reference weights going through
the JAX converter and then ``params_from_jax``. The port's artifact
(``export_model`` → ``load_exported(device="cpu")``) is held

  * to the JAX package's artifact (``jax.export``) on every output key,
    within those tests' ``TOLS["tempered"]`` (keys they do not list: 1e-4,
    ``v2d`` as ``j2d``), detections equal, on both ViT streams;
  * to the port's live forward, bitwise.

The graph holds the kernels as operators (``depth`` K1 and ``2 depth`` K2
on the channels-major stream, ``depth`` K5 on the standard one, whose CPU
implementations are the plain versions), the weights as lifted
parameters, and loads in a process where the port's ``models``,
``factory`` and ``bodymodel`` cannot be imported.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from multihmr_tpu.bodymodel import synthetic_body_model as jsynthetic
from multihmr_tpu.io import export as jexport
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint, convert_torch_checkpoint_anny
from multihmr_tpu.models.multihmr import MultiHMR as JMultiHMR
from multihmr_tpu_torch.bodymodel import anny as tanny
from multihmr_tpu_torch.bodymodel.assets import synthetic_body_model
from multihmr_tpu_torch.bodymodel.core import BodyModel
from multihmr_tpu_torch.io.convert import params_from_jax, params_from_jax_anny
from multihmr_tpu_torch.io.export import (
    as_model_forward,
    export_model,
    kernel_op_counts,
    load_exported,
    make_serving_fn,
)
from multihmr_tpu_torch.models import multihmr_anny as tmodel
from multihmr_tpu_torch.models.multihmr import MultiHMR, MultiHMRNet
from tests.test_anny_checkpoint import make_anny_state_dict
from tests.test_checkpoint import TinyConfig, make_reference_state_dict
from tests.test_torch_anny import TOLS as ANNY_TOLS
from tests.test_torch_anny import _jax_model as _jax_anny
from tests.test_torch_anny import _tiny_cfgs as _anny_cfgs
from tests.test_torch_anny import tempered as anny_tempered
from tests.test_torch_model import TOLS, _rel_err
from tests.torch_pool import child_env

REPO = Path(__file__).resolve().parents[1]
S, B, DET = 56, 2, 0.1
K_TINY = np.asarray([[100.0, 0, S / 2], [0, 100.0, S / 2], [0, 0, 1]], np.float32)
DET_KEYS = ("det_rows", "det_cols", "det_valid")


def _inputs(seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, S, 3)).astype(np.float32)
    return x, np.tile(K_TINY, (B, 1, 1))


def _tempered(sd):
    return {k: (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
            if k.endswith("weight") and v.ndim >= 2 else v for k, v in sd.items()}


@pytest.fixture(scope="module", params=["heads", "ring"])
def smplx(request, tmp_path_factory):
    """Both packages' tiny SMPL-X artifacts on the same weights, one ViT stream."""
    tp = request.param
    cfg = TinyConfig(img_size=S, max_people=4, person_center="j5", compute_dtype="float32")
    sd = _tempered(make_reference_state_dict(cfg, np.random.default_rng(0)))
    params = convert_torch_checkpoint({"model_state_dict": sd}, cfg)
    jbm = jsynthetic()
    names = [f"j{i}" for i in range(jbm.num_output_joints)]
    jm = JMultiHMR(cfg, jbm, person_center_joint_names=names, tp_mode=tp)
    net = MultiHMRNet(cfg, tp_mode=tp)
    net.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
    tm = MultiHMR(cfg, BodyModel.from_arrays(synthetic_body_model(), "cpu"), net=net.eval(),
                  person_center_joint_names=names)
    d = tmp_path_factory.mktemp(f"export_{tp}")
    jdir = jexport.export_model(jm, params, str(d / "jax"), batch_size=B, det_thresh=DET,
                                name="tiny")
    tdir = export_model(tm, str(d / "port"), batch_size=B, det_thresh=DET, name="tiny")
    return SimpleNamespace(tp=tp, cfg=cfg, tm=tm, names=names, jdir=jdir, tdir=tdir,
                           loaded=load_exported(tdir, device="cpu"))


def _hold_to_jax(got, want, tols, default=1e-4):
    """Every key of the JAX artifact's output in the port's, detections
    equal, the rest within ``tols`` (relative to each key's largest
    magnitude)."""
    assert sorted(got) == sorted(want)
    assert int(np.asarray(want["det_valid"]).sum()) > 0
    for k in DET_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in sorted(set(want) - set(DET_KEYS)):
        tol = tols.get(k, tols["j2d"] if k == "v2d" else default)
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel_err(np.asarray(want[k]), got[k].numpy()) <= tol, (k, tol)


def test_artifact_matches_jax_artifact(smplx):
    x, K = _inputs()
    want = jexport.load_exported(smplx.jdir)(x, K)
    got = smplx.loaded(torch.from_numpy(x), torch.from_numpy(K))
    _hold_to_jax(got, want, TOLS["tempered"])


def test_artifact_equals_live_forward(smplx):
    x, K = (torch.from_numpy(a) for a in _inputs(1))
    got = smplx.loaded(x, K)
    with torch.no_grad():
        want = make_serving_fn(smplx.tm, DET)(x, K)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_graph_holds_the_kernel_operators_and_weights(smplx):
    depth = smplx.cfg.vit.depth
    want = ({"flash_fwd_t": depth, "layernorm_cm": 2 * depth, "attention_qkv": 0}
            if smplx.tp == "heads" else
            {"flash_fwd_t": 0, "layernorm_cm": 0, "attention_qkv": depth})
    program = smplx.loaded.program
    assert kernel_op_counts(program.graph) == want
    assert program.example_inputs is None  # the traced batch is not stored
    assert smplx.loaded.meta["kernel_ops"] == want and smplx.loaded.meta["tp_mode"] == smplx.tp
    # the weights are lifted parameters, not constants baked into the graph
    lifted = set(program.graph_signature.parameters)
    assert lifted == {f"net.{k}" for k, _ in smplx.tm.net.named_parameters()}
    for k, p in smplx.tm.net.named_parameters():
        assert torch.equal(program.state_dict[f"net.{k}"], p), k


def test_anny_artifact_matches_jax_and_live(tmp_path):
    jcfg, tcfg = _anny_cfgs()
    sd = anny_tempered(make_anny_state_dict(jcfg, np.random.default_rng(0)))
    variables = jax.device_get(convert_torch_checkpoint_anny({"model_state_dict": sd}, jcfg))
    net = tmodel.MultiHMRAnnyNet(tcfg)
    net.load_state_dict(params_from_jax_anny(variables, tcfg), strict=True)
    bm = tanny.AnnyModel.from_arrays(tanny.synthetic_anny_model(num_vertices=64), "cpu")
    tm = tmodel.MultiHMRAnny(tcfg, bm, net=net.eval())
    jdir = jexport.export_model(_jax_anny(), variables, str(tmp_path / "jax"), batch_size=B,
                                det_thresh=0.2)
    loaded = load_exported(export_model(tm, str(tmp_path / "port"), batch_size=B,
                                        det_thresh=0.2), device="cpu")
    depth = tcfg.vit.depth
    assert loaded.meta["kernel_ops"] == {"flash_fwd_t": depth, "layernorm_cm": 2 * depth,
                                         "attention_qkv": 0}
    x, K = _inputs(2)
    got = loaded(torch.from_numpy(x), torch.from_numpy(K))
    _hold_to_jax(got, jexport.load_exported(jdir)(x, K), ANNY_TOLS["tempered"])
    with torch.no_grad():
        want = make_serving_fn(tm, 0.2)(torch.from_numpy(x), torch.from_numpy(K))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["flash_fwd_t", "layernorm_cm", "attention_qkv"])
def test_operator_opcheck(op, dtype):
    """Schema, fake implementation (shapes, dtypes, strides against the CPU
    implementation) and AOT dispatch of each kernel operator."""
    g = torch.Generator().manual_seed(0)
    if op == "flash_fwd_t":
        q, k, v = (torch.randn((2, 2, 64, 24), generator=g).to(dtype) for _ in range(3))
        args = (q, k, v, 0.125, 21)
    elif op == "layernorm_cm":
        args = (torch.randn((2, 64, 24), generator=g).to(dtype), torch.randn(64, generator=g),
                torch.randn(64, generator=g), 1e-6, dtype)
    else:
        args = (torch.randn((2, 24, 3, 2, 64), generator=g).to(dtype), 0.125)
    result = torch.library.opcheck(getattr(torch.ops.mhmr, op).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


_FRESH_LOAD = """
import json, sys
for name in ("multihmr_tpu_torch.models", "multihmr_tpu_torch.factory",
             "multihmr_tpu_torch.bodymodel"):
    sys.modules[name] = None  # importing any of them now raises
import torch
from multihmr_tpu_torch.io.export import load_exported
ref = torch.load(sys.argv[2])
out = load_exported(sys.argv[1], device=sys.argv[3])(ref["x"], ref["K"])
assert sorted(out) == sorted(ref["out"]), sorted(out)
err = max((out[k].double() - ref["out"][k].double()).abs().max().item() for k in out)
print(json.dumps({"max_abs_diff": err, "model_code": sorted(
    m for m in sys.modules if m.startswith(("multihmr_tpu_torch.models",
                                            "multihmr_tpu_torch.bodymodel"))
    and sys.modules[m] is not None)}))
"""


@pytest.mark.parametrize("smplx", ["heads"], indirect=True)
def test_artifact_is_self_contained(smplx, tmp_path):
    """Two files, and a fresh process loads and runs them with the port's
    models, factory and bodymodel blocked, bitwise as the live forward (the
    child runs this process's torch pool: the outputs depend on it)."""
    assert sorted(os.listdir(smplx.tdir)) == ["meta.json", "model.pt2"]
    x, K = (torch.from_numpy(a) for a in _inputs(3))
    with torch.no_grad():
        out = make_serving_fn(smplx.tm, DET)(x, K)
    ref = tmp_path / "ref.pt"
    torch.save({"x": x, "K": K, "out": out}, ref)
    res = subprocess.run([sys.executable, "-c", _FRESH_LOAD, smplx.tdir, str(ref), "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=child_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.splitlines()[-1]) == {"max_abs_diff": 0.0, "model_code": []}


@pytest.mark.parametrize("smplx", ["heads"], indirect=True)
@pytest.mark.parametrize("recorded,asked", [("cpu", "cuda"), ("cuda", "cpu")])
def test_device_mismatch_raises(smplx, tmp_path, recorded, asked):
    """An artifact is refused on another device type than it was exported
    on, naming both, before it touches a device."""
    d = tmp_path / "a"
    d.mkdir()
    meta = dict(smplx.loaded.meta, device=recorded)
    (d / "meta.json").write_text(json.dumps(meta))  # no model.pt2: it is never read
    with pytest.raises(ValueError, match=f"exported on '{recorded}'.*run on '{asked}'"):
        load_exported(str(d), device=asked)


def test_artifact_drives_serving_stack(smplx):
    """The artifact plugged into the batching server through
    ``as_model_forward`` gives the live model's persons; the server's model
    holds no weights (a meta-device net, as ``factory.build_host_model``)."""
    from multihmr_tpu_torch.ops.image import IMG_NORM_MEAN, IMG_NORM_STD
    from multihmr_tpu_torch.serve.server import build_batched_infer

    with torch.device("meta"):
        host_net = MultiHMRNet(smplx.cfg, tp_mode=smplx.tp)
    host = MultiHMR(smplx.cfg, smplx.tm.body_model, net=host_net,
                    person_center_joint_names=smplx.names)
    batcher, _ = build_batched_infer(host, max_batch=B,
                                     forward_fn=as_model_forward(smplx.loaded),
                                     max_delay_ms=50.0)
    try:
        img = np.random.default_rng(4).uniform(0, 255, (S, S, 3)).astype(np.uint8)
        persons = batcher.submit(img, K_TINY)
    finally:
        batcher.close()
    x = (torch.from_numpy(img).float()[None] / 255.0 - torch.from_numpy(IMG_NORM_MEAN)) \
        / torch.from_numpy(IMG_NORM_STD)
    with torch.inference_mode():
        direct = smplx.tm.forward(x, torch.from_numpy(K_TINY)[None], det_thresh=DET)
    want = smplx.tm.extract_persons(direct)[0]
    assert len(persons) == len(want) > 0
    for got_h, want_h in zip(persons, want):
        np.testing.assert_allclose(got_h["v3d"], want_h["v3d"], rtol=1e-5, atol=1e-5)
    # no weights beside the artifact's: only the head's initial-estimate
    # constants are made on the host
    assert all(p.is_meta or k.startswith("x_attention_head.init_")
               for k, p in host.net.named_parameters())
