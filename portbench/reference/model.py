"""Plain reference of Multi-HMR (SMPL-X), one image at a time.

Written from the model's equations, in plain ``torch``, float32 by default
(``Precision``): a DINOv2 ViT over ``1 + g*g`` tokens (pre-norm blocks,
LayerScale, exact GELU, final LayerNorm), a patch-score MLP with a clamped
sigmoid, 3 x 3 max-pool NMS and the ``max_people`` best cells over the
threshold (ties to the lower cell), an offset MLP, unit-depth camera rays of
the patch centres with their Fourier features, and the HPH head: one query
per person, self-attention among the persons, cross-attention to the
feature map (plus the learned row/column embeddings added at the persons'
cells), an MLP, and residual decoders on the mean parameters (6-D rotations,
shape, camera, expression). Distance is the exponential of the regressed
log-depth rescaled by focal length, clipped to [0, 50] m.

It reads its weights by the checkpoint's names from a dict that the
benchmark draws from the seed, and computes attention in blocks of queries
so that 8,465 tokens fit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.body import Body, rot6d_to_rotmat
from portbench.reference.precision import Precision

QUERY_BLOCK = 1024


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def focal_from_fov(fov, size):
    return size / (2 * math.tan(math.radians(fov) / 2))


class Reference:
    """``cfg``: the configuration file's dict; ``w``: name → tensor;
    ``body``: the body model's arrays."""

    def __init__(self, cfg: dict, w: dict, body: dict, device, control: bool = False,
                 remat: bool = False):
        self.cfg, self.w, self.device = cfg, w, torch.device(device)
        self.P = Precision(control)
        self.body = Body(body, device) if body is not None else None
        self.g = cfg["img_size"] // cfg["patch_size"]
        self.remat = remat

    # -- ViT ------------------------------------------------------------
    def _attention(self, x, pre):
        P, w = self.P, self.w
        N, D = x.shape
        H = self.cfg["num_heads"]
        qkv = P.vit_linear(x, w[pre + "qkv.weight"], w[pre + "qkv.bias"])
        q, k, v = qkv.reshape(N, 3, H, D // H).permute(1, 2, 0, 3)  # [H, N, d] each
        q, k, v = (P.vit_operand(t) for t in (q, k, v))
        out = []
        for s in range(0, N, QUERY_BLOCK):
            logits = q[:, s:s + QUERY_BLOCK] @ k.transpose(1, 2) / math.sqrt(D // H)
            p = torch.softmax(logits, -1)
            out.append(P.vit_operand(p) @ v)
        o = P.vit_store(torch.cat(out, 1).transpose(0, 1).reshape(N, D))
        return P.vit_linear(o, w[pre + "proj.weight"], w[pre + "proj.bias"])

    def _block(self, x, i):
        P, w = self.P, self.w
        pre = f"backbone.blocks.{i}."
        y = P.vit_store(layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"], 1e-6))
        x = P.vit_store(x + self._attention(y, pre + "attn.") * w[pre + "ls1.gamma"])
        y = P.vit_store(layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"], 1e-6))
        h = P.vit_store(gelu(P.vit_linear(y, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"])))
        h = P.vit_linear(h, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"])
        return P.vit_store(x + h * w[pre + "ls2.gamma"])

    def vit(self, x):
        """Normalized image ``[S, S, 3]`` → final-norm patch tokens ``[g*g, D]``."""
        P, w, g, p = self.P, self.w, self.g, self.cfg["patch_size"]
        patches = x.reshape(g, p, g, p, 3).permute(0, 2, 1, 3, 4).reshape(g * g, p * p * 3)
        t = P.vit_linear(patches, w["backbone.patch_embed.weight"], w["backbone.patch_embed.bias"])
        t = torch.cat([w["backbone.cls_token"][0], t], 0) + w["backbone.pos_embed"][0]
        t = P.vit_store(t)
        for i in range(self.cfg["depth"]):
            if self.remat and t.requires_grad:
                t = checkpoint(self._block, t, i, use_reentrant=False)
            else:
                t = self._block(t, i)
        t = layer_norm(t.float(), w["backbone.norm.weight"], w["backbone.norm.bias"], 1e-6)
        return P.vit_store(t[1:])

    # -- detection and rays -----------------------------------------------
    def _mlp(self, x, pre, vit=False):
        P, w = self.P, self.w
        lin = P.vit_linear if vit else P.linear
        h = torch.relu(lin(x, w[pre + "fc0.weight"], w[pre + "fc0.bias"]))
        return lin(h, w[pre + "fc1.weight"], w[pre + "fc1.bias"])

    def score_logits(self, x):
        """The score map's logits ``[g, g]`` of a normalized image."""
        g = self.g
        return self._mlp(self.vit(x), "mlp_classif.", vit=True).float().reshape(g, g)

    def features(self, x, K):
        """Everything per cell: ``scores [g, g]`` and their ``logits``, ``offset [g, g, 2]``,
        ``loc [g, g, 2]`` (pixels, x then y), the feature map ``z [g, g, D]``
        and the ray features ``zK [g, g, 3 + 6 * bands]``."""
        c, g, p = self.cfg, self.g, self.cfg["patch_size"]
        z = self.vit(x)
        logits = self._mlp(z, "mlp_classif.", vit=True).float().reshape(g, g)
        scores = torch.sigmoid(logits).clamp(1e-4, 1 - 1e-4)
        z = z.float()
        offset = self._mlp(z, "mlp_offset.").reshape(g, g, 2)
        ar = torch.arange(g, device=x.device, dtype=torch.float32)
        rows, cols = torch.meshgrid(ar, ar, indexing="ij")
        # rays through the patch centres, the pixel pair taken in (row, col) order
        pix = torch.stack([rows, cols], -1).reshape(1, -1, 2) * p + p // 2
        h = torch.cat([pix, torch.ones_like(pix[..., :1])], -1)
        rays = torch.einsum("ij,nmj->nmi", torch.linalg.inv(K), h)[0]
        freqs = torch.linspace(1.0, c["camera_embedding_max_resolution"] / 2.0,
                               c["camera_embedding_num_bands"], device=x.device)
        f = (rays[..., None] * freqs).reshape(g * g, -1)
        zK = torch.cat([rays, torch.sin(math.pi * f), torch.cos(math.pi * f)], -1)
        loc = (torch.stack([cols, rows], -1) + 0.5 + offset) * p
        return {"scores": scores, "logits": logits, "offset": offset, "loc": loc,
                "z": z.reshape(g, g, -1), "zK": zK.reshape(g, g, -1)}

    def detect(self, scores):
        """The cells NMS and top-K pick from ``scores [g, g]``, row-major."""
        c = self.cfg
        hmax = F.max_pool2d(scores[None, None], 3, stride=1, padding=1)[0, 0]
        kept = (scores * (hmax == scores)).reshape(-1)
        order = torch.sort(kept, descending=True, stable=True).indices[:c["max_people"]]
        order = order[kept[order] >= c["det_thresh"]]
        idx = torch.sort(order).values
        return idx // self.g, idx % self.g

    # -- regression head --------------------------------------------------
    def _ln(self, x, pre):
        return layer_norm(x, self.w[pre + ".weight"], self.w[pre + ".bias"], 1e-5)

    def _heads(self, x, n):
        return x.reshape(n, x.shape[-1] // 32, 32).transpose(0, 1)  # [h, n, 32]

    def head(self, f, rows, cols, K):
        """HPH, distance and body model for the persons at cells
        ``(rows, cols)`` (all of them valid)."""
        P, w, c, g = self.P, self.w, self.cfg, self.g
        hw = "x_attention_head."
        n = rows.shape[0]
        zc = torch.cat([f["z"][rows, cols], f["zK"][rows, cols]], -1)
        offset = f["offset"][rows, cols]
        queries = w[hw + "cross_queries_x"][rows] + w[hw + "cross_queries_y"][cols]
        values = w[hw + "cross_values_x"][rows] + w[hw + "cross_values_y"][cols]
        ctx = torch.cat([f["z"], f["zK"]], -1).reshape(g * g, -1)
        ctx = ctx.index_add(0, rows * g + cols, values)
        init = [w[hw + k] for k in ("init_body_pose", "init_betas", "init_cam")]
        tok = torch.cat([zc + queries] + [t.expand(n, -1) for t in init], -1)
        x = P.linear(tok, w[hw + "to_token_embedding.weight"], w[hw + "to_token_embedding.bias"])
        x = x + w[hw + "pos_embedding"][0]
        for i in range(c["xat_depth"]):
            pre = f"{hw}sa{i}."
            q, k, v = P.linear(self._ln(x, f"{hw}sa_norm{i}"),
                               w[pre + "to_qkv.weight"]).chunk(3, -1)
            q, k, v = (self._heads(t, n) for t in (q, k, v))
            a = torch.softmax(P.einsum("hnd,hmd->hnm", q, k) / math.sqrt(32), -1)
            o = P.einsum("hnm,hmd->hnd", a, v).transpose(0, 1).reshape(n, -1)
            x = x + P.linear(o, w[pre + "to_out.weight"], w[pre + "to_out.bias"])
            pre = f"{hw}ca{i}."
            q = self._heads(P.linear(self._ln(x, f"{hw}ca_norm{i}"), w[pre + "to_q.weight"]), n)
            k, v = P.linear(ctx, w[pre + "to_kv.weight"]).chunk(2, -1)
            k, v = self._heads(k, g * g), self._heads(v, g * g)
            a = torch.softmax(P.einsum("hnd,hmd->hnm", q, k) / math.sqrt(32), -1)
            o = P.einsum("hnm,hmd->hnd", a, v).transpose(0, 1).reshape(n, -1)
            x = x + P.linear(o, w[pre + "to_out.weight"], w[pre + "to_out.bias"])
            pre = f"{hw}ff{i}."
            h = gelu(P.linear(self._ln(x, f"{hw}ff_norm{i}"), w[pre + "fc1.weight"],
                              w[pre + "fc1.bias"]))
            x = x + P.linear(h, w[pre + "fc2.weight"], w[pre + "fc2.bias"])
        dec = lambda k: P.linear(x, w[hw + f"dec{k}.weight"], w[hw + f"dec{k}.bias"])  # noqa: E731
        rotmat = rot6d_to_rotmat((dec("pose") + w[hw + "init_body_pose"]).reshape(n, -1, 6))
        betas = dec("shape") + w[hw + "init_betas"]
        expression = dec("expression") + w[hw + "init_expression"]
        dist_raw = (dec("cam") + w[hw + "init_cam"])[:, 0:1]
        fn = focal_from_fov(c["fovn"], c["img_size"])
        dist = torch.clamp(torch.exp(dist_raw * (K[0, 0] / fn)) - 1e-10, 0.0, 50.0)
        loc = (torch.stack([cols, rows], -1).float() + 0.5 + offset) * c["patch_size"]
        out = self.body.camera(rotmat, betas, expression, loc, dist, K.expand(n, 3, 3), P)
        out.update(rotmat=rotmat, shape=betas, expression=expression, dist=dist,
                   dist_postprocessed=dist_raw, offset=offset, loc=loc,
                   scores=f["scores"][rows, cols])
        return out
