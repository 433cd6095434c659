"""Body-model constants (a copy of ``multihmr_tpu/bodymodel/constants.py``).

Copied rather than imported: importing any module of ``multihmr_tpu.bodymodel``
runs that subpackage's ``__init__``, which imports jax. The 127 SMPL-X output
joint names are the first entries of ``smplx.joint_names.JOINT_NAMES``
(smplx v1.1.1), and the vertex ids of the extra keypoints are smplx's
``vertex_ids`` table.
"""

# The 55 SMPL-X skeleton joints, then 21 vertex keypoints, then 51 face
# landmarks.
SMPLX_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "jaw", "left_eye_smplhf", "right_eye_smplhf",
    "left_index1", "left_index2", "left_index3",
    "left_middle1", "left_middle2", "left_middle3",
    "left_pinky1", "left_pinky2", "left_pinky3",
    "left_ring1", "left_ring2", "left_ring3",
    "left_thumb1", "left_thumb2", "left_thumb3",
    "right_index1", "right_index2", "right_index3",
    "right_middle1", "right_middle2", "right_middle3",
    "right_pinky1", "right_pinky2", "right_pinky3",
    "right_ring1", "right_ring2", "right_ring3",
    "right_thumb1", "right_thumb2", "right_thumb3",
    # vertex-selector extras (21)
    "nose", "right_eye", "left_eye", "right_ear", "left_ear",
    "left_big_toe", "left_small_toe", "left_heel",
    "right_big_toe", "right_small_toe", "right_heel",
    "left_thumb", "left_index", "left_middle", "left_ring", "left_pinky",
    "right_thumb", "right_index", "right_middle", "right_ring", "right_pinky",
    # 51 face landmarks
    "right_eye_brow1", "right_eye_brow2", "right_eye_brow3", "right_eye_brow4",
    "right_eye_brow5", "left_eye_brow5", "left_eye_brow4", "left_eye_brow3",
    "left_eye_brow2", "left_eye_brow1", "nose1", "nose2", "nose3", "nose4",
    "right_nose_2", "right_nose_1", "nose_middle", "left_nose_1", "left_nose_2",
    "right_eye1", "right_eye2", "right_eye3", "right_eye4", "right_eye5",
    "right_eye6", "left_eye4", "left_eye3", "left_eye2", "left_eye1",
    "left_eye6", "left_eye5", "right_mouth_1", "right_mouth_2", "right_mouth_3",
    "mouth_top", "left_mouth_3", "left_mouth_2", "left_mouth_1", "left_mouth_5",
    "left_mouth_4", "mouth_bottom", "right_mouth_4", "right_mouth_5",
    "right_lip_1", "right_lip_2", "lip_top", "left_lip_2", "left_lip_1",
    "left_lip_3", "lip_bottom", "right_lip_3",
]


def get_smplx_joint_names():
    return SMPLX_JOINT_NAMES[:127]


# Vertex ids of the extra keypoints, keyed by body-model topology
# (SMPL-X: 10,475 vertices; SMPL: 6,890).
VERTEX_IDS = {
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
        "lring": 5169, "lpinky": 5286,
        "LBigToe": 5770, "LSmallToe": 5780, "LHeel": 8846,
        "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
    "smpl": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
        "lring": 2556, "lpinky": 2673,
        "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
        "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
}

# Order of the extra joints appended after the FK joints (smplx
# VertexJointSelector: face keypoints, feet, then left/right fingertips) —
# matches SMPLX_JOINT_NAMES[55:76].
EXTRA_JOINT_ORDER = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]


def extra_joint_vertex_ids(model_type: str):
    table = VERTEX_IDS[model_type]
    return [table[name] for name in EXTRA_JOINT_ORDER]


# H36M 17-joint regressor selection used for 3DPW MPJPE (reference
# train.py:397-429): H36M_TO_J14 keeps the first 14 of the 17 reordered.
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
