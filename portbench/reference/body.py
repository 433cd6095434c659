"""Plain reference of the rotations, the SMPL-X body model and its camera
placement, in float32.

The body model is linear blend skinning with shape and expression
blendshapes, pose correctives, a joint regressor, forward kinematics along
the kinematic tree, and output joints that append vertex keypoints and face
landmarks (barycentric points of faces) to the skeleton. The camera layer
poses the body with the root rotation about the pelvis, places the
person-centre joint (the head) at the un-projection of the detected pixel at
the regressed distance, and projects to pixels.
"""

from __future__ import annotations

import torch

HEAD_JOINT = 15  # "head" among the SMPL-X joint names


def rot6d_to_rotmat(x):
    """``(..., 6)``: two row 3-vectors → columns ``b1, b2, b1 x b2``
    (Gram-Schmidt)."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / torch.sqrt((a1 * a1).sum(-1, keepdim=True) + 1e-12)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.sqrt((a2 * a2).sum(-1, keepdim=True) + 1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def rodrigues(r):
    """Axis-angle ``(..., 3)`` → rotation ``(..., 3, 3)``."""
    t2 = (r * r).sum(-1)[..., None, None]
    t = torch.sqrt(t2.clamp(min=1e-12))
    small = t2 < 1e-12
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2.clamp(min=1e-12))
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(r.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a * k + b * (k @ k)


def project(p, K, P):
    """Camera-space points ``[n, m, 3]`` → pixels ``[n, m, 2]`` by ``K [n, 3, 3]``."""
    y = p / p[..., 2:3]
    return P.einsum("nij,nmj->nmi", K, y)[..., :2]


def unproject(px, K, dist):
    """Pixels ``[n, m, 2]`` → camera points ``K^-1 [u, v, 1] * dist``."""
    h = torch.cat([px, torch.ones_like(px[..., :1])], -1)
    return torch.einsum("nij,nmj->nmi", torch.linalg.inv(K), h) * dist


class Body:
    """The body model's arrays as float32 tensors on ``device``."""

    def __init__(self, arrays: dict, device):
        f = lambda k: torch.as_tensor(arrays[k], dtype=torch.float32, device=device)  # noqa: E731
        i = lambda k: torch.as_tensor(arrays[k], dtype=torch.int64, device=device)  # noqa: E731
        self.v_template, self.shapedirs, self.exprdirs = f("v_template"), f("shapedirs"), f(
            "exprdirs")
        self.posedirs, self.J_regressor, self.weights = f("posedirs"), f("J_regressor"), f(
            "lbs_weights")
        self.extra, self.faces, self.lmk_faces = i("extra_joint_vertex_ids"), i("faces"), i(
            "lmk_faces_idx")
        self.lmk_bary = f("lmk_bary_coords")
        self.parents = [int(p) for p in arrays["parents"]]

    def lbs(self, rot, betas, expression, P):
        """``rot [n, J, 3, 3]`` local rotations (root first), ``betas [n, b]``,
        ``expression [n, e]`` or None → vertices ``[n, V, 3]``, joints
        ``[n, J + extra + landmarks, 3]``."""
        n, J = rot.shape[:2]
        V = self.v_template.shape[0]
        nb = betas.shape[-1]
        v = self.v_template + P.einsum("nb,vcb->nvc", betas, self.shapedirs[..., :nb])
        if expression is not None and self.exprdirs.shape[-1]:
            ne = expression.shape[-1]
            v = v + P.einsum("ne,vce->nvc", expression, self.exprdirs[..., :ne])
        rest = P.einsum("jv,nvc->njc", self.J_regressor, v)
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        feat = (rot[:, 1:] - eye).reshape(n, -1)
        v = v + P.linear(feat, self.posedirs.T).reshape(n, V, 3)
        world_R, world_t = [], []
        for j in range(J):
            p = self.parents[j]
            if p < 0:
                world_R.append(rot[:, j])
                world_t.append(rest[:, j])
            else:
                world_R.append(P.einsum("nab,nbc->nac", world_R[p], rot[:, j]))
                world_t.append(P.einsum("nab,nb->na", world_R[p], rest[:, j] - rest[:, p])
                               + world_t[p])
        R = torch.stack(world_R, 1)
        posed = torch.stack(world_t, 1)
        t = posed - P.einsum("njab,njb->nja", R, rest)
        # per-vertex transform: skinning weights blend R and t
        Rv = P.einsum("vj,njab->nvab", self.weights, R)
        tv = P.einsum("vj,nja->nva", self.weights, t)
        verts = P.einsum("nvab,nvb->nva", Rv, v) + tv
        lmk = P.einsum("nlkc,lk->nlc", verts[:, self.faces[self.lmk_faces]], self.lmk_bary)
        return verts, torch.cat([posed, verts[:, self.extra], lmk], 1)

    def camera(self, rotmat, betas, expression, loc, dist, K, P):
        """The camera layer for ``n`` persons: ``rotmat [n, 53, 3, 3]``
        (root, 21 body, 15 + 15 hands, jaw), ``loc [n, 2]`` pixels,
        ``dist [n, 1]``, ``K [n, 3, 3]``."""
        n = rotmat.shape[0]
        eye = torch.eye(3, dtype=rotmat.dtype, device=rotmat.device).expand(n, 1, 3, 3)
        local = torch.cat([eye, rotmat[:, 1:22], rotmat[:, 52:53], eye, eye,
                           rotmat[:, 22:37], rotmat[:, 37:52]], 1)
        verts, joints = self.lbs(local, betas, expression, P)
        R = rotmat[:, 0]
        pelvis = joints[:, :1]
        joints = P.einsum("nab,nmb->nma", R, joints - pelvis)
        verts = P.einsum("nab,nmb->nma", R, verts - pelvis)
        transl = unproject(loc[:, None], K, dist[:, None])[:, 0]
        centre = joints[:, HEAD_JOINT:HEAD_JOINT + 1]
        j3d = joints - centre + transl[:, None]
        v3d = verts - centre + transl[:, None]
        return {"v3d": v3d, "j3d": j3d, "j2d": project(j3d, K, P), "v2d": project(v3d, K, P),
                "transl": transl, "transl_pelvis": j3d[:, :1]}
