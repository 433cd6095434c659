"""3DPW test set (SMPL male/female pseudo-GT, eval only)
(``multihmr_tpu/data/threedpw.py``).

Equivalent of reference datasets/threedpw.py:24-215: per-sequence pkl
metadata → per-image annotations with camera-extrinsic-baked root pose and
translation recomputation. ``__init__``, ``__getitem__`` and ``__len__`` are
copies of the JAX package's; ``build_dataset`` runs the GT SMPL forward that
the bake needs through the port's own body model (user-supplied
SMPL_MALE/FEMALE.pkl), on the CPU in fp32. ``tests/test_torch_threedpw.py``
holds it to the JAX package's.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


class THREEDPW:
    name = "3dpw"

    def __init__(
        self,
        split: str = "test",
        img_size: int = 512,
        root_dir: str = "data/3DPW",
        annotations_dir: str = "data",
        smpl_dir: str = "models",
        force_build_dataset: bool = False,
        n: int = -1,
        subsample: int = 1,
    ):
        assert split == "test"
        self.split = split
        self.img_size = img_size
        self.root_dir = root_dir
        self.smpl_dir = smpl_dir
        self.image_dir = os.path.join(root_dir, "imageFiles")
        self.annot_file = os.path.join(annotations_dir, f"{self.name}_{split}.pkl")
        if force_build_dataset or not os.path.isfile(self.annot_file):
            self.annots = self.build_dataset()
        else:
            with open(self.annot_file, "rb") as f:
                self.annots = pickle.load(f)
        self.imagenames = sorted(self.annots.keys())
        # n-truncation before subsample, matching the reference BEDLAM
        # order (datasets/bedlam.py:83-87); the reference THREEDPW swallows
        # n via **kwargs (datasets/threedpw.py:32) — we honor it.
        if n >= 0:
            self.imagenames = self.imagenames[:n]
        if subsample > 1:
            self.imagenames = self.imagenames[::subsample]

    def build_dataset(self) -> dict:
        from PIL import Image

        from multihmr_tpu_torch.bodymodel.assets import load_smpl_pkl
        from multihmr_tpu_torch.bodymodel.core import BodyModel, lbs_forward
        from multihmr_tpu_torch.ops.rotations import rotmat_to_rotvec, rotvec_to_rotmat

        layers = {
            g: BodyModel.from_arrays(
                load_smpl_pkl(os.path.join(self.smpl_dir, "smpl", f"SMPL_{g.upper()}.pkl")),
                "cpu")
            for g in ("male", "female")
        }

        @torch.no_grad()
        def person_fwd(bm, poses, shape, R):
            """(root pose with the camera rotation baked in, vertices, joints)."""
            poses, shape, R = (torch.from_numpy(np.asarray(a, np.float32))
                               for a in (poses, shape, R))
            root_pose = rotmat_to_rotvec(R @ rotvec_to_rotmat(poses[0]))
            rots = rotvec_to_rotmat(torch.cat([root_pose[None], poses[1:]], 0)[None])
            out = lbs_forward(bm, rots, shape[None])
            return root_pose.numpy(), out["vertices"][0].numpy(), out["joints"][0].numpy()

        annots = {}
        seq_dir = os.path.join(self.root_dir, "sequenceFiles", self.split)
        for fn in sorted(os.listdir(seq_dir)):
            with open(os.path.join(seq_dir, fn), "rb") as f:
                meta = pickle.load(f, encoding="latin1")
            K = meta["cam_intrinsics"]
            focal = np.array([K[0, 0], K[1, 1]], np.float32)
            princpt = np.array([K[0, 2], K[1, 2]], np.float32)
            seq_name = fn.replace(".pkl", "")
            seq_len = len(meta["poses"][0])
            n_person = len(meta["genders"])
            for k in range(seq_len):
                img_path = os.path.join(seq_name, f"image_{k:05d}.jpg")
                full = os.path.join(self.image_dir, img_path)
                if not os.path.exists(full):
                    continue
                with Image.open(full) as im:
                    width, height = im.size
                T = meta["cam_poses"][k]
                R, t = T[:3, :3], T[:3, -1]
                persons = []
                for i in range(n_person):
                    if meta["campose_valid"][i][k] == 0:
                        continue
                    poses = meta["poses"][i][k].reshape(24, 3)
                    trans = meta["trans"][i][k]
                    shape = meta["betas"][i][:10]
                    gender = "male" if meta["genders"][i] == "m" else "female"
                    # bake the camera rotation into the root (reference
                    # threedpw.py:119-141)
                    root_pose, v3d, j3d = person_fwd(layers[gender], poses, shape, R)
                    mesh_cam = v3d + trans.reshape(1, 3)
                    joint_cam = j3d + trans.reshape(1, 3)
                    root_cam = joint_cam[0, None, :]
                    mesh_cam = mesh_cam - root_cam + root_cam @ R.T + t
                    real_trans = (mesh_cam - v3d)[0]
                    persons.append(
                        {
                            "smpl_root_pose": root_pose.reshape(1, 3).astype(np.float32),
                            "smpl_body_pose": poses[1:].astype(np.float32),
                            "smpl_shape": shape.reshape(10).astype(np.float32),
                            "smpl_transl": real_trans.reshape(3).astype(np.float32),
                            "smpl_gender": gender,
                        }
                    )
                if persons:
                    annots[img_path] = {
                        "focal": focal,
                        "princpt": princpt,
                        "size": np.array([width, height], np.int32),
                        "humans": persons,
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
        img_pil = Image.open(os.path.join(self.image_dir, name)).convert("RGB")
        img_pil = ImageOps.contain(img_pil, (self.img_size, self.img_size))
        img_pil = ImageOps.pad(img_pil, size=(self.img_size, self.img_size))
        x = np.asarray(img_pil)
        from multihmr_tpu_torch.data.collate import square_canvas_K

        # reference threedpw.py:192-202 K update (shared formula, collate.py)
        annot["K"] = square_canvas_K(
            annot["focal"], annot["princpt"], annot["size"], self.img_size
        )
        annot.pop("princpt"), annot.pop("focal")
        for hum in annot["humans"]:
            hum["smpl_gender_id"] = np.asarray(
                {"male": 1, "female": 2}[hum["smpl_gender"]]
            )
        return normalize_nhwc(x), annot

    def __repr__(self):
        return f"{self.name}: split={self.split} - N={len(self.imagenames)}"
