"""BEDLAM dataset (training + val).

Equivalent of reference datasets/bedlam.py:23-313: builds per-image
annotations from the official npz files (pose_cam/shape/cam_int/cam_ext/
trans_cam), loads images with the BEDLAM closeup −90° rotation fix, applies
horizontal-flip augmentation with exact SMPL-X pose mirroring, and sorts
persons by camera distance. Emits per-image dicts consumed by
``collate_padded`` → ``prepare_gt``.

A copy of the JAX package's module on the port's own ``io/preprocessing.py``
and ``data/collate.py``, held equal to it by ``tests/test_torch_data.py``.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Optional

import numpy as np

# left/right body-joint swap pairs for SMPL-X body_pose mirroring
# (reference datasets/bedlam.py:292-296)
FLIP_PAIRS = ((0, 1), (3, 4), (6, 7), (9, 10), (12, 13), (15, 16), (17, 18), (19, 20))


def flip_smplx_params(hum: dict) -> dict:
    """Mirror a person's SMPL-X parameters for a horizontally flipped image
    (reference datasets/bedlam.py:266-308): negate y/z axis-angle
    components, swap left/right body joints and hands."""
    out = dict(hum)
    transl = hum["smplx_transl"].copy()
    transl[0] = -transl[0]
    out["smplx_transl"] = transl
    for key in ("smplx_root_pose", "smplx_jaw_pose"):
        p = hum[key].copy()
        p[:, 1:3] *= -1
        out[key] = p
    body = hum["smplx_body_pose"].copy()
    for a, b in FLIP_PAIRS:
        body[[a, b]] = body[[b, a]]
    body[:, 1:3] *= -1
    out["smplx_body_pose"] = body
    lhand = hum["smplx_left_hand_pose"].copy()
    rhand = hum["smplx_right_hand_pose"].copy()
    lhand[:, 1:3] *= -1
    rhand[:, 1:3] *= -1
    out["smplx_left_hand_pose"], out["smplx_right_hand_pose"] = rhand, lhand
    if "smplx_leye_pose" in hum:
        leye, reye = hum["smplx_leye_pose"].copy(), hum["smplx_reye_pose"].copy()
        leye[:, 1:3] *= -1
        reye[:, 1:3] *= -1
        out["smplx_leye_pose"], out["smplx_reye_pose"] = reye, leye
    return out


class BEDLAM:
    name = "bedlam"

    def __init__(
        self,
        split: str = "training",
        training: bool = False,
        img_size: int = 896,
        root_dir: str = "data/BEDLAM",
        annotations_dir: str = "data",
        flip: bool = True,
        n_iter: Optional[int] = None,
        n: int = -1,
        subsample: int = 1,
        extension: str = "png",
        res: Optional[int] = None,
        force_build_dataset: bool = False,
        seed: Optional[int] = None,
    ):
        self.split = split
        self.training = training
        self.img_size = img_size
        self.root_dir = root_dir
        self.image_dir = os.path.join(root_dir, split)
        self.flip = flip
        self.n_iter = n_iter
        # Training-mode sampling RNG. Under --num_workers threads the draw
        # ORDER across workers is nondeterministic (same property as torch
        # DataLoader workers); the state itself stays consistent under the
        # GIL. Seeded runs are reproducible only with num_workers=0.
        self._rng = random.Random(seed)
        self.annot_file = os.path.join(annotations_dir, f"{self.name}_{split}.pkl")
        if force_build_dataset or not os.path.isfile(self.annot_file):
            self.annots = self.build_dataset()
        else:
            with open(self.annot_file, "rb") as f:
                self.annots = pickle.load(f)
        # JPEG mode: remap annot keys to the ``create_jpeg`` siblings
        # (reference datasets/bedlam.py:62-78 — BEDLAM ships 1280×720 PNGs,
        # training reads the smaller JPEGs; K is untouched because contain()
        # rescales to img_size from the original aspect either way).
        assert extension in ("png", "jpg"), extension
        if extension == "jpg":
            self.annots = {
                (k[:-3] + "jpg" if res is None else k[:-4] + f"_{res}.jpg"): v
                for k, v in self.annots.items()
            }
        self.imagenames = sorted(self.annots.keys())
        # Truncation-then-subsample order matches the reference
        # (datasets/bedlam.py:83-87; n is the --train_n/--val_n
        # "debugging purpose only" flag, train.py:553,556).
        if n >= 0:
            self.imagenames = self.imagenames[:n]
        if subsample > 1:
            self.imagenames = self.imagenames[::subsample]

    def build_dataset(self) -> dict:
        """Official npz → per-image annotations
        (reference datasets/bedlam.py:98-190)."""
        annots = {}
        annot_dir = os.path.join(self.root_dir, f"all_npz_12_{self.split}")
        for fn in sorted(os.listdir(annot_dir)):
            data = np.load(os.path.join(annot_dir, fn))
            pose_cam = data["pose_cam"]
            K_arr = data["cam_int"]
            H_arr = data["cam_ext"]
            shape_arr = data["shape"]
            imgname_arr = data["imgname"]
            trans_cam = data["trans_cam"]
            for imgname in sorted(set(imgname_arr.tolist())):
                img_path = os.path.join(fn[:-4], "png", imgname)
                full = os.path.join(self.image_dir, img_path)
                if not os.path.exists(full):
                    continue
                from PIL import Image

                with Image.open(full) as im:
                    width, height = im.size
                if "closeup" in img_path:
                    width, height = height, width
                idxs = np.where(imgname_arr == imgname)[0]
                persons = []
                for i in idxs:
                    pose = pose_cam[i]
                    persons.append(
                        {
                            "smplx_root_pose": pose[:3].reshape(1, 3),
                            "smplx_body_pose": pose[3:66].reshape(21, 3),
                            "smplx_jaw_pose": pose[66:69].reshape(1, 3),
                            "smplx_leye_pose": pose[69:72].reshape(1, 3),
                            "smplx_reye_pose": pose[72:75].reshape(1, 3),
                            "smplx_left_hand_pose": pose[75:120].reshape(15, 3),
                            "smplx_right_hand_pose": pose[120:165].reshape(15, 3),
                            "smplx_shape": shape_arr[i].reshape(-1)[:11],
                            "smplx_gender": "neutral",
                            "smplx_transl": trans_cam[i] + H_arr[i][:3, 3],
                        }
                    )
                K = K_arr[idxs[0]]
                annots[img_path] = {
                    "focal": np.array([K[0, 0], K[1, 1]], np.float32),
                    "princpt": np.array([K[0, 2], K[1, 2]], np.float32),
                    "size": np.array([width, height], np.int32),
                    "humans": persons,
                }
        os.makedirs(os.path.dirname(self.annot_file), exist_ok=True)
        with open(self.annot_file, "wb") as f:
            pickle.dump(annots, f, protocol=pickle.HIGHEST_PROTOCOL)
        return annots

    def __len__(self):
        return self.n_iter if self.n_iter is not None else len(self.imagenames)

    def __getitem__(self, idx: int):
        from multihmr_tpu_torch.io.preprocessing import normalize_nhwc
        from PIL import Image, ImageOps

        if self.training:
            idx = self._rng.randrange(len(self.imagenames))
        name = self.imagenames[idx]
        annot = dict(self.annots[name])
        annot["imagename"] = name
        rw, rh = annot["size"]

        from multihmr_tpu_torch.data.collate import square_canvas_K

        # reference bedlam.py:208-213 K update (shared formula, collate.py)
        K = square_canvas_K(
            annot["focal"], annot["princpt"], annot["size"], self.img_size
        )

        img_pil = Image.open(os.path.join(self.image_dir, name)).convert("RGB")
        # BEDLAM closeup rotation fix (reference datasets/bedlam.py:221-223)
        if "closeup" in name and self.split != "test":
            img_pil = img_pil.rotate(-90, expand=True)

        flip = bool(self.flip and self.training and self._rng.choice([0, 1]))
        if flip:
            img_pil = ImageOps.mirror(img_pil)
            K[0, 2] = self.img_size - K[0, 2]

        img_pil = ImageOps.contain(img_pil, (self.img_size, self.img_size))
        img_pil = ImageOps.pad(img_pil, size=(self.img_size, self.img_size))
        x = normalize_nhwc(np.asarray(img_pil))

        annot["K"] = K
        annot.pop("princpt"), annot.pop("focal")

        humans = annot.pop("humans")
        if self.training:  # person must be in front of the camera
            humans = [h for h in humans if h["smplx_transl"][-1] > 0.01]
        humans = sorted(humans, key=lambda h: h["smplx_transl"][-1])  # by depth
        for hum in humans:
            hum["smplx_gender_id"] = np.asarray(0)
        if flip:
            humans = [flip_smplx_params(h) for h in humans]
        annot["humans"] = humans
        return x, annot

    def __repr__(self):
        return f"{self.name}: split={self.split} - N={len(self.imagenames)}"
