"""Plain reference of Multi-HMR's Anny family (``multiHMR_672_L_anny``), one
image at a time.

Written from the published model (naver/multi-hmr, ``multi_hmr_anny/``:
``encoder.py``, ``hph.py``, ``pos_embed.py``, ``multi_hmr.py``) and the
equations of the Anny body model, in plain ``torch``, float32 by default
(``Precision``; TF32 is turned off for both backends when the reference
is built, so that a card's float32 products are float32):

* encoder: the DINOv2 ViT of ``reference/model.py`` (its blocks, read
  under the ``backbone.`` names), whose final-norm class token gives the
  field of view, ``fov = pi * sigmoid(mlp_fov_unique(cls))``, and with it
  ``K_regressed`` (focal ``(S / 2) / tan(fov / 2)``, the principal point at
  the centre); ``mlp_det`` over every patch token gives the detection
  logits, and a plain sigmoid the scores;
* detection: 3 x 3 max-pool NMS and the ``max_people`` best cells at or
  over the threshold (``Reference.detect``);
* queries: ``dec_to_token`` of the patch tokens plus the 2-D sincos
  embedding ``dec_pos_emb`` (:func:`pos_embed_2d`), read at the persons'
  cells; the context is the same map over every cell;
* decoder: ``xat_depth`` pre-norm layers of self-attention among the
  persons, cross-attention over the context and a GELU MLP, each added to
  its input;
* heads: two-layer ReLU MLPs for the offset (``loc = (cell + 0.5 +
  offset) * patch``), the distance (``focal / max(exp(d), 1e-5)`` with the
  focal of the K given), the phenotypes (sigmoid) and the bone rotations
  (6-D in the column-pair layout plus ``init_body_pose``, Gram-Schmidt, and
  the bones that :data:`USEFUL_ROTMAT` marks 0 pinned to the identity);
* body: the phenotypes the model uses picked by name, the phenotype
  lattice interpolated multilinearly into blendshape coefficients,
  blendshapes, the rest joints by the joint regressor, forward kinematics
  along the bone tree and linear blend skinning; the mesh re-centred on the
  ``head`` bone and placed at ``transl``, the un-projection of ``loc`` at
  the distance.

Departures from the published code, none of which changes a person's
numbers:

* Only the detected persons are computed, without the masked padding
  slots: the published masks leave a valid slot's values as they are.
* Ties between equal scores go to the lower cell (a stable sort), as in
  ``reference/model.py``; ``torch.topk`` leaves their order open.
* K is given, as the demo gives it; ``K_regressed`` and ``fov`` are
  returned beside it.
* The lattice is interpolated one phenotype after another (a linear blend
  of two slices, six times), not summed over its 64 corners: the same
  multilinear value.
* No pose correctives: Anny's skinning has none, and an asset that holds
  any is refused.
* The persons are not sorted by depth: the judge matches them by cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.body import unproject
from portbench.reference.model import Reference, gelu, layer_norm

# the phenotypes the network's shape vector feeds, by name (multi_hmr.py:170-172)
USED_PHENOTYPES = ("age", "gender", "weight", "height", "muscle", "proportions")

# which of the 163 bone rotations are regressed (1) or pinned to identity (0),
# as multi_hmr_anny/multi_hmr.py lists them
USEFUL_ROTMAT = torch.tensor(
    [1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0], dtype=torch.bool)


def pos_embed_2d(dim: int, g: int) -> torch.Tensor:
    """The decoder's 2-D sincos embedding ``[g, g, dim]`` (pos_embed.py): at
    cell (row, col), the sines then cosines of the column over ``dim / 4``
    frequencies ``10000^(-i / (dim / 4))``, then those of the row."""
    omega = 1.0 / 10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4))
    ang = np.arange(g, dtype=np.float64)[:, None] * omega  # [g, dim / 4]
    one = np.concatenate([np.sin(ang), np.cos(ang)], 1)  # [g, dim / 2]
    rows, cols = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    return torch.as_tensor(np.concatenate([one[cols], one[rows]], -1), dtype=torch.float32)


def init_pose(n_bones: int) -> torch.Tensor:
    """``[1, 6 n_bones]``: the root turned by pi/2 about x, the other bones at
    the identity, each as its first two columns flattened row by row."""
    R = torch.eye(3).repeat(n_bones, 1, 1)
    R[0] = torch.tensor([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
    return R[:, :, :2].reshape(1, -1)


def rot6d_cols(x):
    """``(..., 6)``, the first two columns of R flattened row by row →
    ``(..., 3, 3)``: the columns ``b1``, ``b2`` by Gram-Schmidt, ``b1 x b2``."""
    a = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = a[..., 0], a[..., 1]
    b1 = a1 / torch.sqrt((a1 * a1).sum(-1, keepdim=True) + 1e-12)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.sqrt((a2 * a2).sum(-1, keepdim=True) + 1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


class AnnyBody:
    """The Anny asset's arrays (an asset dict: the skeleton, the blendshapes,
    the phenotype lattice and the labels) as float32 tensors on ``device``."""

    def __init__(self, arrays: dict, device):
        def f(k):
            return torch.as_tensor(np.asarray(arrays[k], np.float32), device=device)

        if np.any(arrays["posedirs"]):
            raise ValueError("an Anny asset has no pose correctives")
        self.v_template, self.shapedirs = f("v_template"), f("shapedirs")
        self.J_regressor, self.weights = f("J_regressor"), f("lbs_weights")
        self.knots, self.lattice = f("pheno_knots"), f("pheno_lattice")
        self.parents = [int(p) for p in arrays["parents"]]
        labels = [str(s) for s in arrays["phenotype_labels"]]
        self.used = [labels.index(n) for n in USED_PHENOTYPES]
        self.head = [str(s) for s in arrays["bone_labels"]].index("head")

    def coeffs(self, phenotypes):
        """``[n, 6]`` phenotypes (:data:`USED_PHENOTYPES`) → ``[n, n_blend]``
        blendshape coefficients: each phenotype clamped to its knots, and the
        lattice ``[nk ** 6, n_blend]`` (last phenotype fastest) blended
        linearly between the two knots around it, one phenotype at a time."""
        nk = self.knots.shape[1]
        out = []
        for p in phenotypes:
            L = self.lattice.reshape((nk,) * len(USED_PHENOTYPES) + (-1,))
            for d, k in enumerate(self.knots):
                v = torch.clamp(p[d], k[0], k[-1])
                i = int(torch.clamp((k <= v).sum() - 1, 0, nk - 2))
                t = (v - k[i]) / torch.clamp(k[i + 1] - k[i], min=1e-12)
                L = (1 - t) * L[i] + t * L[i + 1]
            out.append(L)
        return torch.stack(out)

    def pose(self, rot, coeffs, P):
        """Local bone rotations ``[n, J, 3, 3]`` (root first) and coefficients
        ``[n, n_blend]`` → vertices ``[n, V, 3]`` and the posed bone heads
        ``[n, J, 3]``."""
        nb = self.shapedirs.shape[-1]
        v = self.v_template + P.einsum("nb,vcb->nvc", coeffs[:, :nb], self.shapedirs)
        rest = P.einsum("jv,nvc->njc", self.J_regressor, v)
        world_R, world_t = [], []
        for j, p in enumerate(self.parents):
            if p < 0:
                world_R.append(rot[:, j])
                world_t.append(rest[:, j])
            else:
                world_R.append(P.einsum("nab,nbc->nac", world_R[p], rot[:, j]))
                world_t.append(P.einsum("nab,nb->na", world_R[p], rest[:, j] - rest[:, p])
                               + world_t[p])
        R, posed = torch.stack(world_R, 1), torch.stack(world_t, 1)
        # each vertex: the skinning weights' blend of the bones' transforms
        # x -> R_j (x - rest_j) + posed_j, applied to the shaped rest vertex
        Rv = P.einsum("vj,njab->nvab", self.weights, R)
        tv = P.einsum("vj,nja->nva", self.weights, posed - P.einsum("njab,njb->nja", R, rest))
        return P.einsum("nvab,nvb->nva", Rv, v) + tv, posed


class AnnyReference(Reference):
    """``cfg``: the configuration file's dict; ``w``: checkpoint name →
    tensor (the port's names, ``encoder.backbone.*`` and the rest);
    ``asset``: the Anny asset's arrays, or None for the scores alone."""

    def __init__(self, cfg: dict, w: dict, asset, device, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(cfg, {k.removeprefix("encoder."): v for k, v in w.items()}, None,
                         device, control=control)
        self.body = AnnyBody(asset, device) if asset is not None else None

    def encode(self, x):
        """Normalized image ``[S, S, 3]`` → the final-norm class token ``[D]``
        and patch tokens ``[g*g, D]``, as float32."""
        P, w, g, p = self.P, self.w, self.g, self.cfg["patch_size"]
        patches = x.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4).reshape(g * g, p * p * 3)
        t = P.vit_linear(patches, w["backbone.patch_embed.weight"], w["backbone.patch_embed.bias"])
        t = P.vit_store(torch.cat([w["backbone.cls_token"][0], t], 0) + w["backbone.pos_embed"][0])
        for i in range(self.cfg["depth"]):
            t = self._block(t, i)
        t = P.vit_store(layer_norm(t.float(), w["backbone.norm.weight"], w["backbone.norm.bias"],
                                   1e-6)).float()
        return t[0], t[1:]

    def score_logits(self, x):
        return self._mlp(self.encode(x)[1], "mlp_det.").reshape(self.g, self.g)

    def features(self, x):
        """Everything per image: the detection ``logits [g, g]`` and
        ``scores``, the regressed ``fov`` and ``K_regressed``, and the
        decoder's map ``dec [g*g, xat_dim]`` (none of which depends on K)."""
        P, w, S = self.P, self.w, self.cfg["img_size"]
        cls, z = self.encode(x)
        logits = self._mlp(z, "mlp_det.").reshape(self.g, self.g)
        fov = math.pi * torch.sigmoid(self._mlp(cls[None], "mlp_fov_unique."))[0, 0]
        focal = (S / 2.0) / torch.tan(fov / 2.0)
        K_reg = torch.eye(3, device=x.device)
        K_reg[0, 0] = K_reg[1, 1] = focal
        K_reg[:2, 2] = S / 2.0
        dec = (P.linear(z, w["dec_to_token.weight"], w["dec_to_token.bias"])
               + w["dec_pos_emb"].reshape(self.g * self.g, -1))
        return {"logits": logits, "scores": torch.sigmoid(logits), "fov": fov,
                "K_regressed": K_reg, "dec": dec}

    def _split(self, x):
        d = self.cfg["xat_dim_head"]
        return x.reshape(x.shape[0], -1, d).transpose(0, 1)  # [heads, n, d]

    def _attend(self, q, k, v):
        P = self.P
        q, k, v = self._split(q), self._split(k), self._split(v)
        a = torch.softmax(P.einsum("hnd,hmd->hnm", q, k) / math.sqrt(q.shape[-1]), -1)
        return P.einsum("hnm,hmd->hnd", a, v).transpose(0, 1).reshape(q.shape[1], -1)

    def decode(self, x, ctx):
        """The persons' queries ``[n, X]`` through the decoder over the
        context ``[g*g, X]``."""
        P, w = self.P, self.w
        for i in range(self.cfg["xat_depth"]):
            pre = f"decoder.sa{i}."
            q, k, v = P.linear(self._ln(x, f"decoder.sa_norm{i}"),
                               w[pre + "to_qkv.weight"]).chunk(3, -1)
            x = x + P.linear(self._attend(q, k, v), w[pre + "to_out.weight"],
                             w[pre + "to_out.bias"])
            pre = f"decoder.ca{i}."
            q = P.linear(self._ln(x, f"decoder.ca_norm{i}"), w[pre + "to_q.weight"])
            k, v = P.linear(ctx, w[pre + "to_kv.weight"]).chunk(2, -1)
            x = x + P.linear(self._attend(q, k, v), w[pre + "to_out.weight"],
                             w[pre + "to_out.bias"])
            pre = f"decoder.ff{i}."
            h = gelu(P.linear(self._ln(x, f"decoder.ff_norm{i}"), w[pre + "fc1.weight"],
                              w[pre + "fc1.bias"]))
            x = x + P.linear(h, w[pre + "fc2.weight"], w[pre + "fc2.bias"])
        return x

    def head(self, f, rows, cols, K):
        """Decoder, heads and body model for the persons at cells
        ``(rows, cols)`` (all of them valid), placed with ``K [3, 3]``."""
        c, w, g, p = self.cfg, self.w, self.g, self.cfg["patch_size"]
        n = rows.shape[0]
        y = self.decode(f["dec"][rows * g + cols], f["dec"])
        offset = self._mlp(y, "mlp_offset.")
        loc = (torch.stack([cols, rows], -1).float() + 0.5 + offset) * p
        dist = K[0, 0] / torch.clamp(torch.exp(self._mlp(y, "mlp_dist.")), min=1e-5)  # [n, 1]
        transl = unproject(loc[:, None], K.expand(n, 3, 3), dist[:, None])[:, 0]
        shape = torch.sigmoid(self._mlp(y, "mlp_shape."))
        init = w["init_body_pose"]
        rot6d = self._mlp(torch.cat([y, init.expand(n, -1)], -1), "mlp_pose.") + init
        J = init.shape[-1] // 6
        rotmat = rot6d_cols(rot6d.reshape(n, J, 6))
        eye = torch.eye(3, device=rotmat.device).expand_as(rotmat)
        rotmat = torch.where(USEFUL_ROTMAT[:J].to(rotmat.device)[:, None, None], rotmat, eye)
        body = self.body
        verts, joints = body.pose(rotmat, body.coeffs(shape[:, body.used]), self.P)
        centre = joints[:, body.head:body.head + 1]
        v3d = verts - centre + transl[:, None]
        j3d = joints - centre + transl[:, None]
        return {"loc": loc, "offset": offset, "dist": dist, "transl": transl, "shape": shape,
                "rotmat": rotmat, "v3d": v3d, "j3d": j3d, "transl_pelvis": j3d[:, :1],
                "fov": f["fov"], "K_regressed": f["K_regressed"]}
