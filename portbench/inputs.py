"""Inputs made from the seed: frames, the body model, training batches.

Every mix draws a fixed set of sizes and counts, and the seed changes only
the pixels, the persons and the order, so that two seeds do the same work.
Frames are made on the device in a few large calls and copied to the host
once, as uint8 RGB.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image, ImageOps

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def frames(sizes: list, per_size: int, seed: int, device) -> list:
    """``per_size`` frames of each ``[w, h]`` in ``sizes``, in an order drawn
    from the seed: smooth colour waves with seeded phases and frequencies,
    a few bright blobs, and pixel noise."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = []
    for w, h in sizes:
        yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None, None]
        xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :, None]
        ph = torch.rand((per_size, 1, 1, 3), generator=g, device=device) * 2 * math.pi
        fx = 12 + 30 * torch.rand((per_size, 1, 1, 3), generator=g, device=device)
        fy = 12 + 30 * torch.rand((per_size, 1, 1, 3), generator=g, device=device)
        img = torch.sin(xx / fx + ph) * torch.cos(yy / fy - ph)
        blobs = torch.rand((per_size, 6, 3), generator=g, device=device)
        for b in range(6):
            cx, cy, r = blobs[:, b, 0] * w, blobs[:, b, 1] * h, 20 + blobs[:, b, 2] * h / 4
            d2 = ((xx[..., 0] - cx[:, None, None]) ** 2 + (yy[..., 0] - cy[:, None, None]) ** 2)
            img = img + torch.exp(-d2 / (2 * r[:, None, None] ** 2))[..., None]
        img = 100 * (img + 1.5) + 12 * torch.randn(img.shape, generator=g, device=device)
        u8 = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        out.extend(u8[i] for i in range(per_size))
    order = np.random.default_rng(seed).permutation(len(out))
    return [out[i] for i in order]


def camera_K(img_size: int, fov: float) -> np.ndarray:
    """K of the padded square image: the focal length of ``fov`` degrees over
    the whole side, the principal point at its centre."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = img_size / (2 * math.tan(math.radians(fov) / 2))
    K[0, 2] = K[1, 2] = img_size // 2
    return K


def contain_pad(frame: np.ndarray, img_size: int) -> np.ndarray:
    """Aspect-preserving bicubic resize into the square and a centred zero
    pad (PIL's ``ImageOps.contain`` and ``ImageOps.pad``), uint8."""
    im = ImageOps.contain(Image.fromarray(frame).convert("RGB"), (img_size, img_size))
    return np.asarray(ImageOps.pad(im, size=(img_size, img_size)))


def normalize(u8: np.ndarray) -> np.ndarray:
    return (u8.astype(np.float32) / 255.0 - IMG_MEAN) / IMG_STD


def body_model(sizes: dict, seed: int) -> dict:
    """A synthetic body model with SMPL-X's structure at ``sizes`` (10,475
    vertices, 55 joints, 21 vertex keypoints, 51 landmarks in the
    configurations): a branching chain of joints, vertices around them,
    smooth random blendshapes and pose correctives, distance-based skinning
    weights and joint regressor, and faces over neighbouring vertices."""
    V, J = sizes["num_vertices"], sizes["num_joints"]
    rng = np.random.default_rng(seed)
    parents = np.array([-1] + [(j - 1) if j % 3 else max(0, j - 3) for j in range(1, J)])
    joints = np.cumsum(rng.normal(scale=0.15, size=(J, 3)), axis=0)
    joints[0] = 0.0
    v = joints[rng.integers(0, J, size=V)] + rng.normal(scale=0.08, size=(V, 3))
    d2 = ((v[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    jr = np.exp(-d2.T / 0.005)
    order = np.lexsort((v[:, 2], v[:, 1], v[:, 0]))
    k = np.arange(3 * V)
    faces = np.stack([order[k % V], order[(k + 1) % V], order[(k + 2) % V]], 1)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    normal = lambda scale, *shape: f32(rng.standard_normal(shape, np.float32) * scale)  # noqa: E731
    return {
        "v_template": f32(v),
        "shapedirs": normal(0.01, V, 3, sizes["num_betas"]),
        "exprdirs": normal(0.003, V, 3, sizes["num_expression"]),
        "posedirs": normal(0.001, 9 * (J - 1), V * 3),
        "J_regressor": f32(jr / jr.sum(-1, keepdims=True)),
        "lbs_weights": f32(w / w.sum(-1, keepdims=True)),
        "parents": parents.astype(np.int32),
        "extra_joint_vertex_ids": rng.integers(0, V, size=sizes["num_extra"]).astype(np.int32),
        "faces": faces.astype(np.int32),
        "lmk_faces_idx": rng.integers(0, 3 * V, size=sizes["num_lmk"]).astype(np.int32),
        "lmk_bary_coords": f32(rng.dirichlet(np.ones(3), size=sizes["num_lmk"])),
    }


def train_batches(traffic: dict, img_size: int, max_people: int, seed: int, device) -> list:
    """Collated training batches as a BEDLAM loader gives them: each image a
    frame contain-resized and padded into the square with its K moved
    accordingly (focal 1.1 x width), and 1 to ``traffic["max_humans"]``
    persons (53 axis-angle rotations, 10 betas, a translation in front of
    the camera) of which the first ``max_people`` fill the slots."""
    n, B = traffic["batches"], traffic["batch"]
    sizes = traffic["frame_sizes"]
    per = -(-n * B // len(sizes))
    pool = frames(sizes, per, seed, device)[:n * B]
    rng = np.random.default_rng(seed + 1)
    counts = rng.permutation(np.resize(np.arange(1, traffic["max_humans"] + 1), n * B))
    out = []
    for i in range(n):
        imgs, Ks = [], []
        pose = np.zeros((B, max_people, 53, 3), np.float32)
        shape = np.zeros((B, max_people, 10), np.float32)
        transl = np.zeros((B, max_people, 3), np.float32)
        valid = np.zeros((B, max_people), np.float32)
        for b in range(B):
            f = pool[i * B + b]
            h, w = f.shape[:2]
            r = min(img_size / w, img_size / h)
            nw, nh = max(1, round(w * r)), max(1, round(h * r))
            K = np.array([[1.1 * w, 0, w / 2], [0, 1.1 * w, h / 2], [0, 0, 1]], np.float32)
            K[:2] *= np.float32(nw / w)
            K[0, 2] += round((img_size - nw) * 0.5)
            K[1, 2] += round((img_size - nh) * 0.5)
            imgs.append(normalize(contain_pad(f, img_size)))
            Ks.append(K)
            m = int(counts[i * B + b])
            k = min(m, max_people)
            pose[b, :k] = rng.normal(scale=0.2, size=(m, 53, 3))[:k]
            shape[b, :k] = rng.normal(size=(m, 10))[:k]
            transl[b, :k] = np.stack([rng.uniform(-1.5, 1.5, m), rng.uniform(-0.5, 0.5, m),
                                      rng.uniform(3, 8, m)], -1)[:k]
            valid[b, :k] = 1.0
        out.append({"image": np.stack(imgs), "K": np.stack(Ks), "gt_pose": pose,
                    "gt_shape": shape, "gt_transl": transl, "gt_valid": valid})
    return out
