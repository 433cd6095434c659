"""EHF evaluation set (100 images, SMPL-X-aligned GT meshes).

Equivalent of reference datasets/ehf.py:25-157: fixed camera extrinsics
applied to ``*_align.ply`` GT vertices, hardcoded intrinsics, contain+pad
resize with the matching K update. No torch / plyfile / smplx dependencies —
uses the framework's own PLY reader and rotation ops.

A copy of the JAX package's module on the port's own ``io/preprocessing.py``,
``data/collate.py`` and ``data/ply.py``, held equal to it by
``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from multihmr_tpu_torch.data.ply import read_ply_vertices

# Reference datasets/ehf.py:66-74 — the official EHF camera.
EHF_CAM_ROTVEC = np.array([-2.98747896, 0.01172457, -0.05704687])
EHF_CAM_T = np.array([-0.03609917, 0.43416458, 2.37101226])
EHF_K = np.array(
    [
        [1498.22426237, 0, 790.263706],
        [0, 1498.22426237, 578.90334],
        [0, 0, 1],
    ],
    dtype=np.float32,
)


def _rotvec_to_rotmat_np(rv: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rv)
    ax = rv / max(theta, 1e-12)
    K = np.array(
        [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class EHF:
    """Iterable of (normalized image NHWC, annot dict)."""

    name = "ehf"

    def __init__(
        self,
        split: str = "test",
        img_size: int = 512,
        root_dir: str = "data/EHF",
        annotations_dir: str = "data",
        force_build_dataset: bool = False,
        n: int = -1,
        subsample: int = 1,
    ):
        assert split == "test"
        self.split = split
        self.img_size = img_size
        self.root_dir = root_dir
        self.annot_file = os.path.join(annotations_dir, f"{self.name}_{split}.pkl")
        if force_build_dataset or not os.path.isfile(self.annot_file):
            self.annots = self.build_dataset()
        else:
            with open(self.annot_file, "rb") as f:
                self.annots = pickle.load(f)
        self.imagenames = sorted(self.annots.keys())
        # The reference EHF swallows n/subsample via **kwargs
        # (datasets/ehf.py:32); we honor them — the same debugging knob the
        # reference train.py passes every val set (train.py:503-504).
        if n >= 0:
            self.imagenames = self.imagenames[:n]
        if subsample > 1:
            self.imagenames = self.imagenames[::subsample]

    def build_dataset(self) -> dict:
        R = _rotvec_to_rotmat_np(EHF_CAM_ROTVEC)
        annots = {}
        fns = sorted(f for f in os.listdir(self.root_dir) if f.endswith("_align.ply"))
        for fn in fns:
            verts = read_ply_vertices(os.path.join(self.root_dir, fn))
            verts_cam = verts @ R.T + EHF_CAM_T
            img_path = fn.replace("align.ply", "img.png")
            from PIL import Image

            with Image.open(os.path.join(self.root_dir, img_path)) as im:
                width, height = im.size
            annots[img_path] = {
                "focal": np.array([EHF_K[0, 0], EHF_K[1, 1]], np.float32),
                "princpt": np.array([EHF_K[0, 2], EHF_K[1, 2]], np.float32),
                "size": np.array([width, height], np.int32),
                "humans": [{"smplx_vertices": verts_cam.astype(np.float32)}],
            }
        os.makedirs(os.path.dirname(self.annot_file), exist_ok=True)
        with open(self.annot_file, "wb") as f:
            pickle.dump(annots, f, protocol=pickle.HIGHEST_PROTOCOL)
        return annots

    def __len__(self):
        return len(self.imagenames)

    def __getitem__(self, idx: int):
        from multihmr_tpu_torch.io.preprocessing import normalize_nhwc
        from PIL import Image, ImageOps

        name = self.imagenames[idx]
        annot = dict(self.annots[name])
        annot["imagename"] = name
        img_pil = Image.open(os.path.join(self.root_dir, name)).convert("RGB")
        img_pil = ImageOps.contain(img_pil, (self.img_size, self.img_size))
        img_pil = ImageOps.pad(img_pil, size=(self.img_size, self.img_size))
        x = np.asarray(img_pil)
        from multihmr_tpu_torch.data.collate import square_canvas_K

        # reference ehf.py:127-146 K update (shared formula, collate.py)
        annot["K"] = square_canvas_K(
            annot["focal"], annot["princpt"], annot["size"], self.img_size
        )
        annot.pop("princpt"), annot.pop("focal")
        return normalize_nhwc(x), annot
