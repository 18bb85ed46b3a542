"""The tables of ``spec_tpu/core/constants.py`` that the port uses, as
its own copy: the port imports nothing of the JAX package.

``tests/test_torch_constants.py`` holds each one equal to the JAX
package's, value for value and dtype for dtype.
"""

import numpy as np

# ImageNet normalization (reference spec/constants.py:20-21).
IMG_NORM_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMG_NORM_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# 49-joint selector into the 54-joint SMPL output (24 kinematic + 21
# vertex keypoints + 9 extra-regressor joints): 25 OpenPose joints, then
# 24 dataset ground-truth joints.
JOINT49_TO_SMPL54 = np.array([
    24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34,
    8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47, 48, 49, 50, 51, 52,
    53, 24, 26, 25, 28, 27,
], dtype=np.int32)

# SMPL kinematic tree (parent of each of the 24 joints; root = -1).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 20, 21], dtype=np.int32)

# Surface-vertex keypoints appended after the 24 kinematic joints, in
# order: 5 face + 6 feet + 10 fingertips (standard SMPL landmark ids).
EXTRA_VERTEX_JOINT_IDS = np.array([
    332, 6260, 2800, 4071, 583,
    3216, 3226, 3387, 6617, 6624, 6787,
    2746, 2319, 2445, 2556, 2673,
    6191, 5782, 5905, 6016, 6133,
], dtype=np.int32)

NUM_SMPL_JOINTS = 24
NUM_SMPL_VERTICES = 6890
NUM_BETAS = 10

# H36M 17-joint regressor rows -> the eval protocols' joint selections:
# 17 joints (mpi-inf-3dhp), and their first 14 (LSP order, 3DPW).
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]

# Left/right flips (the training augmentation): the SMPL joints, their
# axis-angle pose entries, the 24 dataset joints and the 49-joint set.
SMPL_JOINTS_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
]
SMPL_POSE_FLIP_PERM = [3 * i + k for i in SMPL_JOINTS_FLIP_PERM
                       for k in range(3)]
J24_FLIP_PERM = [
    5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19,
    21, 20, 23, 22,
]
J49_FLIP_PERM = [
    0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22,
    23, 24, 19, 20, 21,
] + [25 + i for i in J24_FLIP_PERM]
