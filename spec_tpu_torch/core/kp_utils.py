"""Keypoint-set correspondence tables: the port's copy of
``spec_tpu/core/kp_utils.py`` (the ``pare.utils.kp_utils`` mapping
helpers behind the reference dataset's USE_3D_CONF path, which copies 2D
keypoint confidences onto SMPL pose joints and 3D joints for in-the-wild
training sets).

The maps follow the joint names of the SMPL kinematic joints and of the
24 SPIN ground-truth joints (the second half of the 49-joint set); an
SMPL joint with no annotated counterpart maps through its nearest
annotated kinematic relative.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

SMPL_JOINT_NAMES = [
    'pelvis', 'left_hip', 'right_hip', 'spine1', 'left_knee', 'right_knee',
    'spine2', 'left_ankle', 'right_ankle', 'spine3', 'left_foot',
    'right_foot', 'neck', 'left_collar', 'right_collar', 'head',
    'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
    'left_wrist', 'right_wrist', 'left_hand', 'right_hand',
]

# SPIN ground-truth joint set (constants.JOINT_NAMES[25:], indices 0-23
# within that set).
_SPIN_GT = {
    'Right Ankle': 0, 'Right Knee': 1, 'Right Hip': 2, 'Left Hip': 3,
    'Left Knee': 4, 'Left Ankle': 5, 'Right Wrist': 6, 'Right Elbow': 7,
    'Right Shoulder': 8, 'Left Shoulder': 9, 'Left Elbow': 10,
    'Left Wrist': 11, 'Neck (LSP)': 12, 'Top of Head (LSP)': 13,
    'Pelvis (MPII)': 14, 'Thorax (MPII)': 15, 'Spine (H36M)': 16,
    'Jaw (H36M)': 17, 'Head (H36M)': 18, 'Nose': 19, 'Left Eye': 20,
    'Right Eye': 21, 'Left Ear': 22, 'Right Ear': 23,
}


def map_spin_joints_to_smpl() -> List[Tuple[List[int], int]]:
    """[(spin_gt_joint_ids, smpl_joint_id), ...] — which annotated SPIN
    joints inform each SMPL kinematic joint's confidence (reference
    consumption: cam_dataset.py:389-394, max over the sources)."""
    m: Dict[int, List[int]] = {
        0: [_SPIN_GT['Pelvis (MPII)'], _SPIN_GT['Right Hip'],
            _SPIN_GT['Left Hip']],
        1: [_SPIN_GT['Left Hip']],
        2: [_SPIN_GT['Right Hip']],
        3: [_SPIN_GT['Spine (H36M)'], _SPIN_GT['Pelvis (MPII)']],
        4: [_SPIN_GT['Left Knee']],
        5: [_SPIN_GT['Right Knee']],
        6: [_SPIN_GT['Spine (H36M)'], _SPIN_GT['Thorax (MPII)']],
        7: [_SPIN_GT['Left Ankle']],
        8: [_SPIN_GT['Right Ankle']],
        9: [_SPIN_GT['Thorax (MPII)'], _SPIN_GT['Neck (LSP)']],
        10: [_SPIN_GT['Left Ankle']],
        11: [_SPIN_GT['Right Ankle']],
        12: [_SPIN_GT['Neck (LSP)'], _SPIN_GT['Thorax (MPII)']],
        13: [_SPIN_GT['Left Shoulder'], _SPIN_GT['Neck (LSP)']],
        14: [_SPIN_GT['Right Shoulder'], _SPIN_GT['Neck (LSP)']],
        15: [_SPIN_GT['Head (H36M)'], _SPIN_GT['Top of Head (LSP)'],
             _SPIN_GT['Nose']],
        16: [_SPIN_GT['Left Shoulder']],
        17: [_SPIN_GT['Right Shoulder']],
        18: [_SPIN_GT['Left Elbow']],
        19: [_SPIN_GT['Right Elbow']],
        20: [_SPIN_GT['Left Wrist']],
        21: [_SPIN_GT['Right Wrist']],
        22: [_SPIN_GT['Left Wrist']],
        23: [_SPIN_GT['Right Wrist']],
    }
    return [(srcs, dst) for dst, srcs in m.items()]


def relation_among_spin_joints() -> List[Tuple[List[int], int]]:
    """[(related_spin_ids, spin_id), ...] in 49-joint indices (offset 25) —
    neighbors whose confidence informs a 3D GT joint (reference
    consumption: cam_dataset.py:396-411, max over relations + itself)."""
    rel = {
        0: [], 1: [], 2: [14], 3: [14], 4: [], 5: [],
        6: [], 7: [], 8: [12, 15], 9: [12, 15], 10: [], 11: [],
        12: [15, 8, 9], 13: [18, 19], 14: [2, 3, 16],
        15: [12, 8, 9], 16: [14, 15], 17: [18, 19],
        18: [13, 17], 19: [17, 18, 20, 21, 22, 23],
        20: [19, 22], 21: [19, 23], 22: [19, 20], 23: [19, 21],
    }
    return [([25 + r for r in srcs], 25 + dst)
            for dst, srcs in rel.items()]
