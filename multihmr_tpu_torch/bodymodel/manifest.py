"""Asset manifest: expected filenames + array shapes for the licensed assets
(``multihmr_tpu/bodymodel/manifest.py``).

A copy of the JAX package's module on the port's own loaders and
checkpoint converter, held equal to it by ``tests/test_torch_checkpoint.py``.

This environment has zero egress, so the licensed SMPL-X/SMPL files and the
released ``multiHMR_*.pt`` checkpoints cannot be fetched — real-weight parity
is pre-staged instead. This module is the
machine-checkable half of that pre-staging: given an assets directory it
verifies that every file the pipeline will load has the exact keys and
shapes the loaders (bodymodel/assets.py) and the reference's own
``smplx.create`` configuration (reference blocks/smpl_layer.py:38:
``use_pca=False, flat_hand_mean=True``) expect, so asset problems surface
as named manifest errors rather than deep loader tracebacks.

Expected layout mirrors the reference's ``SMPLX_DIR`` convention
(reference demo.py:269, datasets/threedpw.py:69-70):

    <assets>/smplx/SMPLX_NEUTRAL.npz
    <assets>/smpl/SMPL_MALE.pkl, SMPL_FEMALE.pkl        (3DPW GT only)
    <assets>/smpl_mean_params.npz                        (train-from-scratch)
    <assets>/smplx2smpl.pkl                              (3DPW eval only)
    <assets>/J_regressor_h36m.npy                        (3DPW eval only)
    <assets>/multiHMR_*.pt                               (released ckpts)

Reference shape provenance: the official SMPL-X NEUTRAL npz (10,475
vertices, 55 joints, 20,908 faces, 300 shape + 100 expression blendshape
columns, 54 pose-corrective joints ⇒ posedirs 486) and SMPL pkl (6,890
vertices, 24 joints, 13,776 faces) — the numbers the smplx package
hardcodes (SMPLX.NUM_BODY_JOINTS etc.) and reference utils/humans.py
assumes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# dim value None = any size accepted (recorded, not checked)
SMPLX_NPZ_SPEC: Dict[str, Tuple[Optional[int], ...]] = {
    "v_template": (10475, 3),
    "shapedirs": (10475, 3, None),  # 400 official (300 shape + 100 expr)
    "posedirs": (10475, 3, 486),  # 9 * (55 - 1)
    "J_regressor": (55, 10475),
    "weights": (10475, 55),
    "kintree_table": (2, 55),
    "f": (20908, 3),
    "lmk_faces_idx": (51,),
    "lmk_bary_coords": (51, 3),
}

SMPL_PKL_SPEC: Dict[str, Tuple[Optional[int], ...]] = {
    "v_template": (6890, 3),
    "shapedirs": (6890, 3, None),  # 10 (legacy) or 300 (extended)
    "posedirs": (6890, 3, 207),  # 9 * (24 - 1)
    "J_regressor": (24, 6890),
    "weights": (6890, 24),
    "kintree_table": (2, 24),
    "f": (13776, 3),
}

MEAN_PARAMS_SPEC: Dict[str, Tuple[Optional[int], ...]] = {
    # smpl_mean_params.npz (reference model.py:442): 24-joint 6d pose
    "pose": (144,),
    "shape": (10,),
    "cam": (3,),
}

# minimum blendshape columns for the pipeline's num_betas/num_expression.
# 20 is the legacy-npz floor (10 shape + 10 expression); the full official
# SMPL-X space is 300 shape (+100 expression) columns, required by every
# num_betas=11 path (assets.py:80 refuses legacy files there, matching the
# reference's unconditional smplx.create(num_betas=11) at train.py:41).
_MIN_SHAPEDIRS = {"SMPLX": 20, "SMPL": 10}
_FULL_SHAPEDIRS_SMPLX = 300

# the two locations factory.load_body_model actually probes (factory.py:42-48)
_SMPLX_LOAD_PATHS = (
    os.path.join("smplx", "SMPLX_NEUTRAL.npz"),
    "SMPLX_NEUTRAL.npz",
)


def _shape_of(x) -> Tuple[int, ...]:
    if hasattr(x, "toarray"):  # scipy sparse
        return tuple(x.shape)
    if hasattr(x, "r"):  # chumpy
        return tuple(np.asarray(x.r).shape)
    return tuple(np.asarray(x).shape)


def _check_mapping(name: str, data, spec: Dict[str, Tuple[Optional[int], ...]],
                   min_blend: int) -> List[str]:
    problems = []
    for key, want in spec.items():
        if key not in data:
            problems.append(f"{name}: missing key '{key}'")
            continue
        got = _shape_of(data[key])
        if len(got) != len(want) or any(
            w is not None and g != w for g, w in zip(got, want)
        ):
            problems.append(f"{name}: '{key}' shape {got}, expected {want}")
    if "shapedirs" in data:
        got = _shape_of(data["shapedirs"])
        if len(got) == 3 and got[-1] < min_blend:
            problems.append(
                f"{name}: shapedirs has {got[-1]} blend columns, "
                f"need >= {min_blend} (10 shape + 10 expression legacy floor)"
            )
    return problems


def check_smplx_npz(path: str,
                    warnings: Optional[List[str]] = None) -> List[str]:
    """Problems list (empty = valid) for an ``SMPLX_*.npz`` asset.

    A legacy 20-column asset is structurally valid for inference with
    num_betas<=10 but is refused by every num_betas=11 path
    (bodymodel/assets.py:80, loaded unconditionally by cli/train.py) — that
    incompatibility is appended to ``warnings`` when given, so the manifest
    and the loaders never disagree silently.
    """
    try:
        data = np.load(path, allow_pickle=True)
    except Exception as e:  # unreadable file is a manifest problem too
        return [f"{os.path.basename(path)}: cannot load ({e})"]
    name = os.path.basename(path)
    problems = _check_mapping(name, data, SMPLX_NPZ_SPEC,
                              _MIN_SHAPEDIRS["SMPLX"])
    if warnings is not None and "shapedirs" in data:
        got = _shape_of(data["shapedirs"])
        if (len(got) == 3
                and _MIN_SHAPEDIRS["SMPLX"] <= got[-1] < _FULL_SHAPEDIRS_SMPLX):
            warnings.append(
                f"{name}: legacy {got[-1]}-column shapedirs — inference with "
                f"num_betas<=10 only; training / GT prep (num_betas=11) "
                f"needs the {_FULL_SHAPEDIRS_SMPLX}-column official npz"
            )
    return problems


def check_constants_against_smplx_npz(path: str) -> List[str]:
    """Cross-check the VENDORED constant tables (bodymodel/constants.py —
    reproduced from the public smplx package v1.1.1, never verified against
    a real asset in this zero-egress environment) against an actual
    ``SMPLX_NEUTRAL.npz``: joint counts, landmark counts, and vertex-id
    ranges must be mutually consistent, or the 127-joint output layout
    (reference utils/humans.py:25-26) silently shifts. Value-level vertex-id
    verification still needs real weights (a wrong id shows up as a
    per-person joint delta in tools/parity_harness.py --stages)."""
    from multihmr_tpu_torch.bodymodel.constants import (
        EXTRA_JOINT_ORDER,
        SMPLX_JOINT_NAMES,
        VERTEX_IDS,
    )

    try:
        data = np.load(path, allow_pickle=True)
    except Exception as e:
        return [f"constants-vs-npz: cannot load {os.path.basename(path)} ({e})"]
    problems = []
    n_fk = _shape_of(data["kintree_table"])[1] if "kintree_table" in data else None
    if n_fk is not None and n_fk != 55:
        problems.append(
            f"constants-vs-npz: npz has {n_fk} FK joints, the vendored "
            f"joint-name table assumes 55 (SMPLX_JOINT_NAMES[:55])")
    n_lmk = _shape_of(data["lmk_faces_idx"])[0] if "lmk_faces_idx" in data else None
    if n_lmk is not None and n_lmk + 55 + len(EXTRA_JOINT_ORDER) != len(
        SMPLX_JOINT_NAMES
    ):
        problems.append(
            f"constants-vs-npz: 55 FK + {len(EXTRA_JOINT_ORDER)} extra + "
            f"{n_lmk} landmarks != {len(SMPLX_JOINT_NAMES)} vendored names")
    if "v_template" in data:
        n_verts = _shape_of(data["v_template"])[0]
        bad = {k: v for k, v in VERTEX_IDS["smplx"].items() if v >= n_verts}
        if bad:
            problems.append(
                f"constants-vs-npz: vertex ids out of range for "
                f"{n_verts}-vertex mesh: {bad}")
    return problems


def check_smpl_pkl(path: str) -> List[str]:
    from multihmr_tpu_torch.bodymodel.assets import _TolerantUnpickler

    try:
        with open(path, "rb") as f:
            data = _TolerantUnpickler(f, encoding="latin1").load()
    except Exception as e:
        return [f"{os.path.basename(path)}: cannot load ({e})"]
    return _check_mapping(
        os.path.basename(path), data, SMPL_PKL_SPEC, _MIN_SHAPEDIRS["SMPL"]
    )


def check_mean_params(path: str) -> List[str]:
    try:
        data = np.load(path)
    except Exception as e:
        return [f"{os.path.basename(path)}: cannot load ({e})"]
    problems = []
    for key, want in MEAN_PARAMS_SPEC.items():
        if key not in data:
            problems.append(f"smpl_mean_params.npz: missing key '{key}'")
            continue
        got = tuple(int(s) for s in np.asarray(data[key]).reshape(-1).shape)
        if got != want:
            problems.append(
                f"smpl_mean_params.npz: '{key}' has {got[0]} values, "
                f"expected {want[0]}"
            )
    return problems


def check_checkpoint(path: str,
                     warnings: Optional[List[str]] = None) -> List[str]:
    """Validate a released ``multiHMR_*.pt`` against the FULL converter
    contract — not just structure (reference demo.py:87-103: ``args`` +
    ``model_state_dict``), but every key name and tensor shape
    ``io.checkpoint.convert_reference_checkpoint`` will consume for the config
    rebuilt from ``ckpt['args']`` (the converter-assumption manifest,
    docs/DESIGN.md). Anny checkpoints (``'anny' in name``, the reference's
    own dispatch rule, demo.py:95) are checked against the Anny key set.

    A missing torch on the host is a verification limitation, not an asset
    problem — it goes to ``warnings`` (when given) so a torch-less machine
    does not flag every valid checkpoint as INVALID.
    """
    name = os.path.basename(path)
    try:
        import torch
    except ImportError:
        if warnings is not None:
            warnings.append(
                f"{name}: unverifiable "
                "(torch not installed; structural check skipped)"
            )
        return []
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:
        return [f"{name}: cannot load ({e})"]
    return check_checkpoint_dict(ckpt, name)


def check_checkpoint_dict(ckpt, name: str) -> List[str]:
    """The loadable part of :func:`check_checkpoint` (testable without a
    .pt file on disk)."""
    problems = []
    for key in ("args", "model_state_dict"):
        if key not in ckpt:
            problems.append(f"{name}: missing '{key}'")
    if problems:
        return problems

    from multihmr_tpu_torch.io.checkpoint import (
        config_from_ckpt_args,
        expected_reference_keys_anny,
        validate_reference_state_dict,
    )

    try:
        cfg = config_from_ckpt_args(ckpt["args"])
    except Exception as e:
        return problems + [f"{name}: cannot rebuild config from args ({e})"]
    sd = {k: v for k, v in ckpt["model_state_dict"].items()
          if not k.startswith(("smpl_layer", "body_model"))}
    if "anny" in name:  # the reference's own dispatch rule (demo.py:95)
        missing = sorted(expected_reference_keys_anny(cfg) - set(sd))
        for k in missing[:20]:
            problems.append(f"{name}: anny converter key missing: {k}")
        if len(missing) > 20:
            problems.append(f"{name}: ... and {len(missing) - 20} more")
        return problems
    report = validate_reference_state_dict(sd, cfg)
    for k in report["missing"][:20]:
        problems.append(f"{name}: converter key missing: {k}")
    if len(report["missing"]) > 20:
        problems.append(f"{name}: ... and {len(report['missing']) - 20} more missing")
    for msg in report["bad_shape"][:20]:
        problems.append(f"{name}: shape contract violated: {msg}")
    if len(report["bad_shape"]) > 20:
        problems.append(
            f"{name}: ... and {len(report['bad_shape']) - 20} more bad shapes")
    return problems


def check_assets_dir(assets_dir: str) -> Dict[str, object]:
    """Walk ``assets_dir`` and validate every recognized asset.

    Returns {"found": {relpath: n_problems}, "missing": [names],
    "problems": [messages], "warnings": [messages]}. Only SMPLX_NEUTRAL.npz
    — at one of the two paths ``factory.load_body_model`` actually probes
    (``<assets>/smplx/SMPLX_NEUTRAL.npz`` or ``<assets>/SMPLX_NEUTRAL.npz``)
    — is REQUIRED for the demo/parity path; everything else is reported as
    missing but does not make the manifest invalid (3DPW/train-only assets).
    Warnings flag usable-but-limited assets (legacy shape space, skipped
    torch verification) without invalidating the manifest.
    """
    found: Dict[str, int] = {}
    problems: List[str] = []
    warnings: List[str] = []
    seen_names = set()
    seen_rels = set()
    for dirpath, _dn, filenames in os.walk(assets_dir):
        for fn in filenames:
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, assets_dir)
            if fn.startswith("SMPLX_") and fn.endswith(".npz"):
                p = check_smplx_npz(path, warnings)
                p += check_constants_against_smplx_npz(path)
            elif fn.startswith("SMPL_") and fn.endswith(".pkl"):
                p = check_smpl_pkl(path)
            elif fn == "smpl_mean_params.npz":
                p = check_mean_params(path)
            elif fn == "smplx2smpl.pkl":
                from multihmr_tpu_torch.bodymodel.assets import load_smplx2smpl

                try:
                    m = load_smplx2smpl(path)
                    p = [] if m.shape == (6890, 10475) else [
                        f"smplx2smpl.pkl: matrix {m.shape}, expected (6890, 10475)"
                    ]
                except Exception as e:
                    p = [f"smplx2smpl.pkl: cannot load ({e})"]
            elif fn == "J_regressor_h36m.npy":
                try:
                    r = np.load(path)
                    p = [] if r.shape == (17, 6890) else [
                        f"J_regressor_h36m.npy: {r.shape}, expected (17, 6890)"
                    ]
                except Exception as e:
                    p = [f"J_regressor_h36m.npy: cannot load ({e})"]
            elif fn.startswith("multiHMR_") and fn.endswith(".pt"):
                p = check_checkpoint(path, warnings)
            else:
                continue
            seen_names.add(fn)
            seen_rels.add(rel)
            found[rel] = len(p)
            problems.extend(p)
    missing = []
    # the REQUIRED check must match what the pipeline will actually load:
    # a SMPLX npz at any other path silently falls back to the synthetic
    # body model (factory.py:42-48) — exactly the failure the manifest
    # exists to catch.
    if not any(rel in seen_rels for rel in _SMPLX_LOAD_PATHS):
        missing.append("smplx/SMPLX_NEUTRAL.npz (REQUIRED for demo/parity)")
        stray = sorted(
            r for r in seen_rels
            if os.path.basename(r).startswith("SMPLX_")
            and r.endswith(".npz")
        )
        if stray:
            problems.append(
                f"SMPL-X npz found at {stray} but the loader only probes "
                f"{list(_SMPLX_LOAD_PATHS)} (factory.load_body_model) — "
                "move/rename it or the pipeline will silently use the "
                "synthetic body model"
            )
    for optional in ("smpl_mean_params.npz", "smplx2smpl.pkl",
                     "J_regressor_h36m.npy"):
        if optional not in seen_names:
            missing.append(f"{optional} (optional: train / 3DPW eval)")
    if not any(n.startswith("SMPL_") for n in seen_names):
        missing.append("smpl/SMPL_MALE.pkl + SMPL_FEMALE.pkl (optional: 3DPW GT)")
    if not any(n.startswith("multiHMR_") for n in seen_names):
        missing.append("multiHMR_<res>_<size>.pt (released checkpoint)")
    return {"found": found, "missing": missing, "problems": problems,
            "warnings": warnings}
