"""Convert the licensed ``anny`` package into the Anny ``.npz`` container
(``multihmr_tpu_torch/bodymodel/anny.py::load_anny_npz``; the JAX package's
``tools/convert_anny.py`` writes the same container).

The reference loads the Anny body model live
(``anny.create_fullbody_model(remove_unattached_vertices=False,
all_phenotypes=True)``); this tool serializes it once, so inference never
imports the package. It probes the package's public forward as a black box:

  * phenotype lattice: ``blendshape_coeffs`` at every knot combination of
    the six used phenotypes (MakeHuman's macro interpolation is
    piecewise-linear with breakpoints at category positions, so a knot grid
    that holds them reproduces the mapping exactly);
  * blendshape targets: identity-pose vertices are affine in the
    coefficients (v = v0 + S·c), solved by least squares on a spanning set;
  * joint regressor: bone positions are affine in the same coefficients;
    W solves W·[v0|S] = [j0|Jd] on the coefficient subspace;
  * hierarchy: rotating one bone moves exactly its descendants;
  * skinning weights: per-vertex ridge least squares over random poses with
    known per-bone transforms A_j = G_j·G_rest_j⁻¹.

A final pass compares the converted model (the port's ``anny_forward``, on
the CPU) with the source on random (pose, phenotype) samples and refuses to
write on a mismatch. The probes are numpy, copied from the JAX package's
tool as they are.

Usage (where the ``anny`` package is installed):
    python -m multihmr_tpu_torch.tools.convert_anny --out models/anny.npz [--knots 5]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from multihmr_tpu_torch.bodymodel.anny import (
    AnnyModel,
    anny_arrays,
    anny_forward,
    save_anny_npz,
)


# ---------------------------------------------------------------------------
# Black-box probing core. ``source`` duck-type:
#   source.forward(pose [B,J,4,4] np, phen {name: [B] np}) ->
#       dict(vertices [B,V,3], bone_poses [B,J,4,4], blendshape_coeffs [B,C])
#   source.bone_labels: list[str]; source.phenotype_labels: list[str]
#   source.num_bones: int
# ---------------------------------------------------------------------------

USED = ("age", "gender", "weight", "height", "muscle", "proportions")


def _identity_poses(B, J):
    return np.broadcast_to(np.eye(4, dtype=np.float32), (B, J, 4, 4)).copy()


def _phen_dict(arr):  # [B, 6] -> dict
    return {n: arr[:, i].astype(np.float32) for i, n in enumerate(USED)}


def _random_rotmats(rng, shape, scale=0.4):
    """Random small rotations via Rodrigues (numpy)."""
    v = rng.normal(scale=scale, size=shape + (3,)).astype(np.float64)
    theta = np.linalg.norm(v, axis=-1, keepdims=True)
    k = v / np.maximum(theta, 1e-12)
    K = np.zeros(shape + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th = theta[..., None]
    eye = np.broadcast_to(np.eye(3), shape + (3, 3))
    return (eye + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)).astype(np.float32)


def probe_lattice(source, knots, chunk=256, rng=None, n_shape_probe=None):
    """Returns (pheno_lattice [nk^6, C], probe_coeffs, probe_verts,
    probe_joints) — the latter three on a spanning probe subset."""
    J = source.num_bones
    nk = len(knots)
    grids = np.meshgrid(*([knots] * 6), indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=-1)  # [nk^6, 6]
    N = pts.shape[0]

    coeffs_all = []
    for i in range(0, N, chunk):
        batch = pts[i : i + chunk]
        out = source.forward(_identity_poses(len(batch), J), _phen_dict(batch))
        coeffs_all.append(np.asarray(out["blendshape_coeffs"], np.float64))
    coeffs_all = np.concatenate(coeffs_all)  # [N, C]
    C = coeffs_all.shape[1]

    # spanning probe subset for the affine fits: random interior points give
    # generic-position coefficient samples
    rng = rng or np.random.default_rng(0)
    n_probe = n_shape_probe or min(N, 2 * (C + 1) + 64)
    probe_pts = rng.uniform(0.05, 0.95, size=(n_probe, 6)).astype(np.float32)
    pv, pj, pc = [], [], []
    for i in range(0, n_probe, chunk):
        batch = probe_pts[i : i + chunk]
        out = source.forward(_identity_poses(len(batch), J), _phen_dict(batch))
        pv.append(np.asarray(out["vertices"], np.float64))
        pj.append(np.asarray(out["bone_poses"], np.float64)[:, :, :3, 3])
        pc.append(np.asarray(out["blendshape_coeffs"], np.float64))
    return coeffs_all, np.concatenate(pc), np.concatenate(pv), np.concatenate(pj)


def fit_affine(coeffs, values):
    """Least-squares fit values_i ≈ v0 + S @ c_i.

    coeffs [N, C], values [N, ...]. Returns (v0 [...], S [..., C], resid)."""
    N, C = coeffs.shape
    A = np.concatenate([np.ones((N, 1)), coeffs], axis=1)  # [N, 1+C]
    flat = values.reshape(N, -1)
    sol, *_ = np.linalg.lstsq(A, flat, rcond=None)  # [1+C, M]
    v0 = sol[0].reshape(values.shape[1:])
    S = sol[1:].T.reshape(values.shape[1:] + (C,))
    resid = np.abs(A @ sol - flat).max()
    return v0, S, resid


def fit_joint_regressor(v0, S, j0, Jd):
    """W [J,V] with W·v0 = j0 and W·S = Jd, exact on the shape subspace."""
    V = v0.shape[0]
    C = S.shape[-1]
    M = np.concatenate([v0.reshape(V, 3), S.reshape(V, 3 * C)], axis=1)  # [V, 3+3C]
    T = np.concatenate([j0.reshape(-1, 3), Jd.reshape(-1, 3 * C)], axis=1)
    W = T @ np.linalg.pinv(M, rcond=1e-10)
    return W


def probe_hierarchy(source, neutral_phen, tol=1e-6):
    """parents[j] from descendant sets: rotating bone j moves exactly its
    strict descendants."""
    J = source.num_bones
    rest = source.forward(
        _identity_poses(1, J), _phen_dict(neutral_phen[None])
    )["bone_poses"][0, :, :3, 3]
    poses = _identity_poses(J, J)
    R90 = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    for j in range(J):
        poses[j, j, :3, :3] = R90
    out = source.forward(poses, _phen_dict(np.broadcast_to(neutral_phen, (J, 6)).copy()))
    moved = (
        np.abs(np.asarray(out["bone_poses"])[:, :, :3, 3] - rest[None]).max(-1) > tol
    )  # moved[j, i]: bone i moves when j is rotated
    np.fill_diagonal(moved, False)
    parents = np.full(J, -1, np.int64)
    desc_sizes = moved.sum(1)
    for i in range(J):
        movers = np.where(moved[:, i])[0]  # ancestors of i
        if len(movers):
            parents[i] = movers[np.argmin(desc_sizes[movers])]
    if not all(parents[j] < j for j in range(J)):
        raise NotImplementedError(
            "anny bone order is not topological (parents[j] >= j somewhere); "
            "add a bone permutation to the container before converting."
        )
    return parents


def probe_lbs_weights(
    source, v0, S, neutral_phen, n_poses=80, rng=None, chunk_v=2048,
    ridge=1e-8,
):
    """Per-vertex ridge least squares for skinning weights.

    For random poses p with neutral shape: x_pj = (A_pj · h(v_shaped))_{:3}
    where A_pj = G_pj · G_rest_j⁻¹; solve v_out ≈ Σ_j w_vj x_pjv."""
    rng = rng or np.random.default_rng(1)
    J = source.num_bones
    V = v0.shape[0]
    phen = np.broadcast_to(neutral_phen, (n_poses, 6)).copy()
    c = source.forward(_identity_poses(1, J), _phen_dict(neutral_phen[None]))[
        "blendshape_coeffs"
    ][0]
    v_shaped = v0 + S @ np.asarray(c, np.float64)  # [V, 3]

    poses = _identity_poses(n_poses, J)
    poses[:, :, :3, :3] = _random_rotmats(rng, (n_poses, J))
    out = source.forward(poses, _phen_dict(phen))
    G = np.asarray(out["bone_poses"], np.float64)  # [P, J, 4, 4]
    verts = np.asarray(out["vertices"], np.float64)  # [P, V, 3]
    G_rest = np.asarray(
        source.forward(_identity_poses(1, J), _phen_dict(neutral_phen[None]))[
            "bone_poses"
        ],
        np.float64,
    )[0]  # [J, 4, 4]
    A = G @ np.linalg.inv(G_rest)[None]  # [P, J, 4, 4]

    vh = np.concatenate([v_shaped, np.ones((V, 1))], axis=1)  # [V, 4]
    weights = np.zeros((V, J))
    for s in range(0, V, chunk_v):
        e = min(V, s + chunk_v)
        # x [P, J, v, 3] = A[:, :, :3, :] @ vh[v]
        x = np.einsum("pjcd,vd->pjvc", A[:, :, :3, :], vh[s:e])
        D = x.transpose(2, 0, 3, 1).reshape(e - s, -1, J)  # [v, 3P, J]
        t = verts[:, s:e].transpose(1, 0, 2).reshape(e - s, -1)  # [v, 3P]
        DtD = np.einsum("vpj,vpk->vjk", D, D) + ridge * np.eye(J)
        Dt = np.einsum("vpj,vp->vj", D, t)
        weights[s:e] = np.linalg.solve(DtD, Dt[..., None])[..., 0]
    weights[np.abs(weights) < 1e-6] = 0.0
    return weights


def convert(source, knots, rng=None, n_poses=80, validate_n=8, tol=2e-4) -> AnnyModel:
    """Probe, fit and validate; returns the port's AnnyModel on the CPU."""
    rng = rng or np.random.default_rng(0)
    J = source.num_bones
    neutral = np.full(6, 0.5, np.float32)

    print(f"[convert_anny] probing lattice ({len(knots)}^6 points)...")
    lattice, pc, pv, pj = probe_lattice(source, knots, rng=rng)
    print("[convert_anny] fitting blendshape targets...")
    v0, S, res_v = fit_affine(pc, pv)
    print(f"  vertex affine residual: {res_v:.2e}")
    j0, Jd, res_j = fit_affine(pc, pj)
    print(f"  joint affine residual:  {res_j:.2e}")
    W = fit_joint_regressor(v0, S, j0, Jd)
    print("[convert_anny] probing hierarchy...")
    parents = probe_hierarchy(source, neutral)
    print("[convert_anny] probing skinning weights...")
    lbs_w = probe_lbs_weights(source, v0, S, neutral, n_poses=n_poses, rng=rng)

    model = AnnyModel.from_arrays(anny_arrays(
        v0, S, W, lbs_w, parents, getattr(source, "faces", np.zeros((0, 3))),
        np.broadcast_to(np.asarray(knots, np.float32), (6, len(knots))), lattice,
        source.bone_labels, source.phenotype_labels), "cpu")

    # --- validation against the source on random (pose, phenotype) ---
    print("[convert_anny] validating...")
    poses = _identity_poses(validate_n, J)
    poses[:, :, :3, :3] = _random_rotmats(rng, (validate_n, J), scale=0.3)
    phen = rng.uniform(0.05, 0.95, size=(validate_n, 6)).astype(np.float32)
    want = source.forward(poses, _phen_dict(phen))
    with torch.no_grad():
        got = anny_forward(model, torch.from_numpy(poses),
                           {k: torch.from_numpy(v) for k, v in _phen_dict(phen).items()})
    got = {k: v.numpy() for k, v in got.items()}
    err_v = float(np.abs(got["vertices"] - want["vertices"]).max())
    err_j = float(np.abs(got["bone_poses"][:, :, :3, 3]
                         - np.asarray(want["bone_poses"])[:, :, :3, 3]).max())
    err_c = float(np.abs(got["blendshape_coeffs"] - want["blendshape_coeffs"]).max())
    print(f"  max |Δvertices|={err_v:.2e}  |Δjoints|={err_j:.2e}  |Δcoeffs|={err_c:.2e}")
    if max(err_v, err_j) > tol:
        raise RuntimeError(
            f"converted model diverges from the source (>{tol}); "
            "try more --knots, more probe poses, or check the pose convention"
        )
    return model


class AnnyPackageSource:
    """Adapter over the real ``anny`` package (requires torch + anny)."""

    def __init__(self):
        import anny
        import torch

        self.torch = torch
        self.model = anny.create_fullbody_model(
            remove_unattached_vertices=False, all_phenotypes=True
        ).to(dtype=torch.float32)
        self.model.set_skinning_method("lbs")
        self.bone_labels = list(self.model.bone_labels)
        self.phenotype_labels = list(self.model.phenotype_labels)
        self.num_bones = len(self.bone_labels)
        faces = getattr(self.model, "faces", None)
        if faces is not None:
            self.faces = np.asarray(faces)

    def forward(self, pose, phen):
        t = self.torch
        with t.no_grad():
            out = self.model(
                pose_parameters=t.from_numpy(np.asarray(pose, np.float32)),
                phenotype_kwargs={
                    k: t.from_numpy(np.asarray(v, np.float32)) for k, v in phen.items()
                },
            )
        return {
            "vertices": out["vertices"].numpy(),
            "bone_poses": out["bone_poses"].numpy(),
            "blendshape_coeffs": out["blendshape_coeffs"].numpy(),
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument(
        "--knots", type=int, default=5,
        help="lattice knots per phenotype (>=3; 3 covers MakeHuman's "
        "child/young/old breakpoints, 5 adds safety margin)",
    )
    ap.add_argument("--poses", type=int, default=80, help="skinning probe poses")
    args = ap.parse_args(argv)

    source = AnnyPackageSource()
    knots = np.linspace(0.0, 1.0, args.knots)
    model = convert(source, knots, n_poses=args.poses)

    save_anny_npz(args.out, model)
    print(f"[convert_anny] wrote {args.out}")


if __name__ == "__main__":
    sys.exit(main())
