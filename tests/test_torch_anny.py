"""The Anny family of the port against the JAX package, on the CPU.

Every comparison is relative to the output's largest magnitude (at least 1).
Errors measured on the CPU and the tolerance each test holds:

  * ``rot6d_cols_to_rotmat`` and ``rotation_to_homogeneous``: measured
    2.8e-7 and 0, held to 1e-6;
  * ``phenotype_to_coeffs`` at knots, at 0 and 1 and between knots: the
    port sums the 64 corners in one reduction where JAX adds them in turn,
    measured 3.0e-8, held to 1e-6;
  * ``anny_forward`` at 163 bones: measured 6.0e-7 (vertices), 4.5e-7
    (bone poses, joints), held to 1e-5;
  * the synthetic model and the ``.npz`` container: equal;
  * the whole slice, ``tests/test_anny.py::tiny_anny``'s configuration with
    ``make_anny_state_dict`` weights through the JAX converter and
    ``params_from_jax_anny``, K given and regressed: detections equal, and
    the outputs within ``TOLS`` (measured values beside them).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multihmr_tpu.bodymodel import anny as janny
from multihmr_tpu.io.checkpoint import convert_torch_checkpoint_anny
from multihmr_tpu.models import multihmr_anny as jmodel
from multihmr_tpu.ops import rotations as jrot
from multihmr_tpu_torch.bodymodel import anny as tanny
from multihmr_tpu_torch.bodymodel.core import world_transforms_homogeneous
from multihmr_tpu_torch.config import ViTConfig
from multihmr_tpu_torch.io.convert import params_from_jax_anny
from multihmr_tpu_torch.models import multihmr_anny as tmodel
from multihmr_tpu_torch.ops import rotations as trot
from tests.test_anny import tiny_anny
from tests.test_anny_checkpoint import make_anny_state_dict
from tests.test_torch_bodymodel import FIELDS
from tests.test_torch_model import _rel_err
import tests.torch_pool  # noqa: F401  (one fixed torch thread pool)

PHEN_TOL = 1e-6
BODY_TOL = 1e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- ops and the body model ----


def test_rotations_match_jax(rng):
    x = rng.normal(size=(4, 7, 6)).astype(np.float32)
    err = _rel_err(jrot.rot6d_cols_to_rotmat(jnp.asarray(x)),
                   _np(trot.rot6d_cols_to_rotmat(torch.from_numpy(x))))
    assert err <= 1e-6, err
    R = rng.normal(size=(3, 5, 3, 3)).astype(np.float32)
    err = _rel_err(jrot.rotation_to_homogeneous(jnp.asarray(R)),
                   _np(trot.rotation_to_homogeneous(torch.from_numpy(R))))
    assert err <= 1e-6, err
    # the identity's 6d decodes to the identity only in this layout
    eye6d = np.eye(3, dtype=np.float32)[:, :2].reshape(-1)
    np.testing.assert_array_equal(_np(trot.rot6d_cols_to_rotmat(torch.from_numpy(eye6d))),
                                  np.eye(3, dtype=np.float32))


def _models(**kw):
    return janny.synthetic_anny_model(**kw), tanny.AnnyModel.from_arrays(
        tanny.synthetic_anny_model(**kw), "cpu")


@pytest.mark.parametrize("num_knots", [3, 5])
def test_phenotype_to_coeffs_matches_jax(rng, num_knots):
    jm, tm = _models(num_vertices=16, num_bones=8, n_blend=7, num_knots=num_knots)
    knots = np.linspace(0.0, 1.0, num_knots)
    between = (knots[:-1] + knots[1:]) / 2
    # at knots (0 and 1 among them), between knots, random, and out of range
    cols = [np.concatenate([knots, between, rng.uniform(0, 1, 5), [-0.2, 1.3]])
            for _ in tanny.USED_PHENOTYPES]
    for c in cols:
        rng.shuffle(c)
    phen = {n: c.astype(np.float32) for n, c in zip(tanny.USED_PHENOTYPES, cols)}
    a = janny.phenotype_to_coeffs(jm, {k: jnp.asarray(v) for k, v in phen.items()})
    b = tanny.phenotype_to_coeffs(tm, {k: torch.from_numpy(v) for k, v in phen.items()})
    err = _rel_err(a, _np(b))
    assert err <= PHEN_TOL, err
    # at a knot combination: the lattice row itself
    at = {n: torch.full((1,), float(knots[1])) for n in tanny.USED_PHENOTYPES}
    row = sum(num_knots ** (5 - d) for d in range(6))
    np.testing.assert_allclose(_np(tanny.phenotype_to_coeffs(tm, at))[0],
                               _np(tm.pheno_lattice)[row], atol=1e-6)


def test_anny_forward_matches_jax(rng):
    jm, tm = _models(num_vertices=96)
    B, J = 3, tanny.NUM_BONES
    R = trot.rotvec_to_rotmat(torch.from_numpy(rng.normal(scale=0.4, size=(B, J, 3))
                                               .astype(np.float32)))
    pose = _np(trot.rotation_to_homogeneous(R))
    phen = {n: rng.uniform(0, 1, B).astype(np.float32) for n in tanny.USED_PHENOTYPES}
    a = janny.anny_forward(jm, jnp.asarray(pose), {k: jnp.asarray(v) for k, v in phen.items()})
    b = tanny.anny_forward(tm, torch.from_numpy(pose),
                           {k: torch.from_numpy(v) for k, v in phen.items()})
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(b[k].shape) == a[k].shape, k
        err = _rel_err(a[k], _np(b[k]))
        assert err <= BODY_TOL, (k, err)
    # the homogeneous layout: rotation block, translation = joint, [0 0 0 1]
    bp = _np(b["bone_poses"])
    np.testing.assert_array_equal(bp[:, :, :3, 3], _np(b["joints"]))
    np.testing.assert_array_equal(bp[:, :, 3], np.broadcast_to([0, 0, 0, 1], (B, J, 4)))


def test_world_transforms_homogeneous_layout(rng):
    R = rng.normal(size=(2, 4, 3, 3)).astype(np.float32)
    t = rng.normal(size=(2, 4, 3)).astype(np.float32)
    got = world_transforms_homogeneous({"world_rot": torch.from_numpy(R),
                                        "joints_fk": torch.from_numpy(t)})
    from multihmr_tpu.bodymodel.core import world_transforms_homogeneous as jwth

    want = jwth({"world_rot": jnp.asarray(R), "joints_fk": jnp.asarray(t)})
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _assert_same_anny(jm, arrays):
    base = {f: getattr(jm.base, f) for f in FIELDS}
    for f in FIELDS + ("pheno_knots", "pheno_lattice"):
        a = np.asarray(base[f] if f in base else getattr(jm, f))
        b = np.asarray(arrays[f])
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert tuple(arrays["bone_labels"]) == jm.bone_labels
    assert tuple(arrays["phenotype_labels"]) == jm.phenotype_labels


@pytest.mark.parametrize("kw", [{}, {"num_vertices": 40, "num_bones": 20, "n_blend": 4,
                                     "num_knots": 4, "seed": 3}])
def test_synthetic_anny_model_equal(kw):
    _assert_same_anny(janny.synthetic_anny_model(**kw), tanny.synthetic_anny_model(**kw))


def test_anny_npz_loads_in_either_package(tmp_path):
    jm, tm = _models(num_vertices=32, num_bones=20, n_blend=5)
    janny.save_anny_npz(str(tmp_path / "j.npz"), jm)
    tanny.save_anny_npz(str(tmp_path / "t.npz"), tm)
    # the JAX file in the port, the port's file in the JAX package: equal
    _assert_same_anny(janny.load_anny_npz(str(tmp_path / "j.npz")),
                      tanny.load_anny_npz(str(tmp_path / "j.npz")))
    _assert_same_anny(janny.load_anny_npz(str(tmp_path / "t.npz")),
                      tanny.load_anny_npz(str(tmp_path / "j.npz")))
    loaded = tanny.AnnyModel.from_arrays(tanny.load_anny_npz(str(tmp_path / "j.npz")), "cpu")
    assert loaded.person_center_index("head") == 15 and loaded.num_vertices == 32
    assert loaded.used_phenotype_indices() == [0, 1, 2, 3, 4, 5]


def test_constants_and_config_equal():
    np.testing.assert_array_equal(tmodel.USEFUL_ROTMAT, jmodel.USEFUL_ROTMAT)
    for n in (tanny.NUM_BONES, 5):
        np.testing.assert_array_equal(tmodel._default_init_pose(n),
                                      np.asarray(jmodel._default_init_pose(n)))
    assert tanny.USED_PHENOTYPES == janny.USED_PHENOTYPES
    assert tanny.PHENOTYPE_LABELS == janny.PHENOTYPE_LABELS
    assert tanny.NUM_BONES == janny.NUM_BONES
    jf = [(f.name, f.default) for f in dataclasses.fields(jmodel.AnnyConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tmodel.AnnyConfig)]
    assert tf == jf
    t, j = tmodel.AnnyConfig(), jmodel.AnnyConfig()
    assert (t.vit.embed_dim, t.vit.depth, t.patch_size, t.grid_size) == (
        j.vit.embed_dim, j.vit.depth, j.patch_size, j.grid_size) == (1024, 24, 14, 48)


# ---- the whole slice ----

# Measured (K given / K regressed): "unit" weights, activations of 1e3-1e5:
# shape 1.2e-5, rotmat 3.8e-5, rotvec 2.2e-5, v3d and j3d 2.4e-5, the rest
# <= 4.7e-6; the depth head's exp overflows, so every person sits at
# distance 0 and j2d (a division by ~0 depths) is not compared, as in
# tests/test_torch_model.py. "tempered" (fan_in^-0.5, people 0.1-0.7 m
# away): rotmat 2.3e-5, v3d and j3d 2.9e-6, j2d 4.3e-6, the rest <= 3.6e-7.
OUT = ("scores", "K_regressed", "fov_regressed", "loc", "dist", "shape", "rotmat", "rotvec",
       "transl", "v3d", "j3d", "j2d", "blendshape_coeffs")
GEOM = ("rotmat", "rotvec", "v3d", "j3d")
TOLS = {
    "unit": {**{k: 1e-4 for k in OUT if k != "j2d"}, **dict.fromkeys(GEOM, 2e-4)},
    "tempered": {**dict.fromkeys(OUT, 1e-4), "j2d": 1e-3},
}


def _tiny_cfgs():
    j = tiny_anny().cfg
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "vit_override"}
    v = j.vit_override
    return j, tmodel.AnnyConfig(**kw, vit_override=ViTConfig(
        embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads))


def tempered(sd):
    """``make_anny_state_dict``'s weights scaled by fan_in^-0.5."""
    for k, v in sd.items():
        if k.endswith("weight") and v.ndim >= 2:
            sd[k] = (v / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32)
    return sd


@functools.lru_cache(maxsize=None)
def _jax_model():
    # re-centred on the bone labelled "head", as the port (tiny_anny pins index 5)
    return jmodel.MultiHMRAnny(_tiny_cfgs()[0], janny.synthetic_anny_model(num_vertices=64))


@functools.lru_cache(maxsize=None)
def _jax_forward(K_given: bool):
    """The JAX forward, jitted once for both weight sets."""
    jm = _jax_model()
    if K_given:
        return jax.jit(lambda p, x, K: jm.forward(p, x, K, det_thresh=0.2, batch_mode="fused"))
    return jax.jit(lambda p, x: jm.forward(p, x, det_thresh=0.2, batch_mode="fused"))


@pytest.fixture(scope="module", params=["unit", "tempered"])
def anny_pair(request):
    """(weights name, JAX model, JAX variables, port model) on the same weights."""
    jcfg, tcfg = _tiny_cfgs()
    sd = make_anny_state_dict(jcfg, np.random.default_rng(0))
    if request.param == "tempered":
        sd = tempered(sd)
    variables = jax.device_get(convert_torch_checkpoint_anny({"model_state_dict": sd}, jcfg))
    jm = _jax_model()
    net = tmodel.MultiHMRAnnyNet(tcfg)
    net.load_state_dict(params_from_jax_anny(variables, tcfg), strict=True)
    bm = tanny.AnnyModel.from_arrays(tanny.synthetic_anny_model(num_vertices=64), "cpu")
    tm = tmodel.MultiHMRAnny(tcfg, bm, net=net.eval())
    assert tm.person_center_idx == jm.person_center_idx == 15
    return request.param, jm, variables, tm


@pytest.mark.parametrize("K_given", [True, False])
def test_slice_matches_jax(anny_pair, rng, K_given):
    weights, jm, variables, tm = anny_pair
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    K = np.array([[[100.0, 0, 28], [0, 100, 28], [0, 0, 1]]] * 2, np.float32) if K_given else None
    a = _jax_forward(K_given)(variables, x, *([K] if K_given else []))
    with torch.inference_mode():
        b = tm.forward(torch.from_numpy(x), None if K is None else torch.from_numpy(K),
                       det_thresh=0.2)
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(_np(getattr(b["det"], f)),
                                      np.asarray(getattr(a["det"], f)), err_msg=f)
    assert int(np.asarray(a["det"].valid).sum()) > 0
    if K_given:
        np.testing.assert_array_equal(_np(b["K"]), K)
    else:  # the regressed K is the one used
        np.testing.assert_array_equal(_np(b["K"]), _np(b["K_regressed"]))
    for k, tol in TOLS[weights].items():
        assert tuple(b[k].shape) == a[k].shape, k
        err = _rel_err(a[k], _np(b[k]))
        assert err <= tol, (k, err)
    pa, pb = jm.extract_persons(a), tm.extract_persons(b)
    assert [len(p) for p in pb] == [len(p) for p in pa]
    for img_a, img_b in zip(pa, pb):
        for per_a, per_b in zip(img_a, img_b):  # same near-to-far order
            assert sorted(per_a) == sorted(per_b)
            assert _rel_err(per_a["transl"], per_b["transl"]) <= TOLS[weights]["transl"]
            assert _rel_err(per_a["v3d"], per_b["v3d"]) <= TOLS[weights]["v3d"]
        depths = [float(p["transl"][2]) for p in img_b]
        assert depths == sorted(depths)


def test_params_from_jax_anny_maps_every_leaf(anny_pair):
    _, jm, variables, tm = anny_pair
    cfg = tm.cfg
    sd = params_from_jax_anny(variables, cfg)
    qkv = variables["params"]["encoder"]["backbone"]["blocks"]["block"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["encoder.backbone.blocks.0.attn.qkv.weight"].numpy(),
                                  np.asarray(qkv)[0].T)
    np.testing.assert_array_equal(sd["init_body_pose"].numpy(),
                                  np.asarray(variables["constants"]["init_body_pose"]))
    extra = dict(variables, params=dict(variables["params"], stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="stray"):
        params_from_jax_anny(extra, cfg)
    missing = dict(variables, params={k: v for k, v in variables["params"].items()
                                      if k != "mlp_offset"})
    with pytest.raises(KeyError, match="mlp_offset"):
        params_from_jax_anny(missing, cfg)
    no_const = dict(variables, constants={"dec_pos_emb": variables["constants"]["dec_pos_emb"]})
    with pytest.raises(KeyError, match="init_body_pose"):
        params_from_jax_anny(no_const, cfg)
    bad = dict(variables, constants=dict(variables["constants"],
                                         init_body_pose=np.zeros((1, 6), np.float32)))
    with pytest.raises(ValueError, match="init_body_pose"):
        params_from_jax_anny(bad, cfg)
