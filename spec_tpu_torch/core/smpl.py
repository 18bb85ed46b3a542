"""SMPL body model in PyTorch (twin of ``spec_tpu/core/smpl.py``).

Model tensors live in a plain :class:`SMPLAssets` dataclass; the forward
pass is a set of functions over (betas, pose rotmats), batched over the
leading axis and always fp32 with TF32 off. Vertices go either through
the plain blendshape + skinning path (:func:`lbs`) or, when the assets
carry packed operands (:func:`with_packed_lbs`), through the fused LBS
CUDA kernel (:func:`lbs_fused`, ``ops/lbs.py``).

:func:`load_smpl_assets` reads smplx-style ``.pkl`` files without
chumpy and ``.npz`` dumps; :func:`create_test_assets` builds the same
synthetic model as the reference's (same ``RandomState`` sequence).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from spec_tpu_torch.core import constants as C
from spec_tpu_torch.utils.graphs import device_constant
from spec_tpu_torch.utils.precision import fp32_matmuls, fp32_precision


@dataclasses.dataclass(frozen=True)
class SMPLAssets:
    """SMPL model tensors. V = vertices (6890 for SMPL), J = 24 joints,
    10 shape betas, P = 23 * 9 = 207 pose features."""

    v_template: torch.Tensor        # (V, 3)
    shapedirs: torch.Tensor         # (10, V*3)
    posedirs: torch.Tensor          # (P, V*3)
    j_regressor: torch.Tensor       # (J, V)
    lbs_weights: torch.Tensor       # (V, J)
    parents: tuple                  # len J
    faces: Optional[torch.Tensor] = None             # (F, 3)
    extra_vertex_ids: Optional[tuple] = None         # len 21
    j_regressor_extra: Optional[torch.Tensor] = None  # (9, V)
    j_regressor_h36m: Optional[torch.Tensor] = None   # (17, V)
    # Operands of the fused LBS kernel; attach with with_packed_lbs.
    packed_lbs: Optional[object] = None

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device) -> 'SMPLAssets':
        """Copy of the assets with every tensor on ``device``."""
        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if dataclasses.is_dataclass(x):
                return x.to(device)
            return x

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SMPLOutput:
    vertices: torch.Tensor           # (B, V, 3)
    joints: torch.Tensor             # (B, K, 3), K set by the joint set
    joints_native: torch.Tensor      # (B, 24, 3)
    global_transforms: torch.Tensor  # (B, 24, 4, 4)


# ---------------------------------------------------------------------------
# Asset loading
# ---------------------------------------------------------------------------


class _ChumpyTolerantUnpickler(pickle.Unpickler):
    """Unpickles smplx-style SMPL .pkl files without chumpy installed by
    mapping chumpy arrays onto a numpy-backed stub."""

    def find_class(self, module, name):  # noqa: D102
        if module.startswith('chumpy'):
            return _ChArrayStub
        if module in ('scipy.sparse.csc', 'scipy.sparse._csc'):
            import scipy.sparse
            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


class _ChArrayStub:
    """Minimal stand-in for chumpy.Ch: keeps only the ndarray payload."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.__dict__.get('x'))
        return arr.astype(dtype) if dtype is not None else arr


def _to_np(x) -> np.ndarray:
    if hasattr(x, 'toarray'):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def load_smpl_assets(
    model_path: str,
    gender: str = 'neutral',
    j_regressor_extra_path: Optional[str] = None,
    j_regressor_h36m_path: Optional[str] = None,
) -> SMPLAssets:
    """Load SMPL tensors (on the CPU) from a .pkl/.npz file or a model
    directory holding ``SMPL_{GENDER}.pkl``."""
    path = model_path
    if os.path.isdir(path):
        cand = os.path.join(path, f'SMPL_{gender.upper()}.pkl')
        if not os.path.exists(cand):
            cand = os.path.join(path, f'SMPL_{gender.upper()}.npz')
        path = cand

    if path.endswith('.pkl'):
        with open(path, 'rb') as f:
            data = _ChumpyTolerantUnpickler(f, encoding='latin1').load()
    else:
        data = dict(np.load(path, allow_pickle=True))

    v_template = _to_np(data['v_template']).astype(np.float32)    # (V, 3)
    shapedirs = _to_np(data['shapedirs']).astype(np.float32)      # (V, 3, B*)
    shapedirs = shapedirs[:, :, :C.NUM_BETAS]
    posedirs = _to_np(data['posedirs']).astype(np.float32)        # (V, 3, P)
    j_regressor = _to_np(data['J_regressor']).astype(np.float32)  # (J, V)
    lbs_weights = _to_np(data['weights']).astype(np.float32)      # (V, J)
    parents = _to_np(data['kintree_table'])[0].astype(np.int64)
    parents[0] = -1
    faces = _to_np(data['f']).astype(np.int32)

    V = v_template.shape[0]
    jre = jrh = None
    if j_regressor_extra_path and os.path.exists(j_regressor_extra_path):
        jre = torch.from_numpy(
            np.load(j_regressor_extra_path).astype(np.float32))
    if j_regressor_h36m_path and os.path.exists(j_regressor_h36m_path):
        jrh = torch.from_numpy(
            np.load(j_regressor_h36m_path).astype(np.float32))

    return SMPLAssets(
        v_template=torch.from_numpy(v_template),
        shapedirs=torch.from_numpy(shapedirs.reshape(V * 3, -1).T.copy()),
        posedirs=torch.from_numpy(posedirs.reshape(V * 3, -1).T.copy()),
        j_regressor=torch.from_numpy(j_regressor),
        lbs_weights=torch.from_numpy(lbs_weights),
        parents=tuple(int(x) for x in parents),
        faces=torch.from_numpy(faces),
        extra_vertex_ids=tuple(int(x) for x in C.EXTRA_VERTEX_JOINT_IDS),
        j_regressor_extra=jre,
        j_regressor_h36m=jrh,
    )


def create_test_assets(
    num_vertices: int = C.NUM_SMPL_VERTICES, seed: int = 0,
    with_extra: bool = True,
) -> SMPLAssets:
    """Deterministic synthetic SMPL-shaped assets, identical to
    ``spec_tpu.core.smpl.create_test_assets`` for the same arguments."""
    rng = np.random.RandomState(seed)
    V, J, B = num_vertices, C.NUM_SMPL_JOINTS, C.NUM_BETAS
    P = (J - 1) * 9
    v_template = rng.randn(V, 3).astype(np.float32) * 0.3
    shapedirs = rng.randn(B, V * 3).astype(np.float32) * 0.01
    posedirs = rng.randn(P, V * 3).astype(np.float32) * 0.001
    jr = rng.rand(J, V).astype(np.float32)
    jr /= jr.sum(axis=1, keepdims=True)
    w = rng.rand(V, J).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    faces = rng.randint(0, V, size=(V * 2, 3)).astype(np.int32)
    extra_ids = (tuple(int(x) for x in
                       C.EXTRA_VERTEX_JOINT_IDS % num_vertices)
                 if with_extra else None)
    jre = jrh = None
    if with_extra:
        jre = rng.rand(9, V).astype(np.float32)
        jre /= jre.sum(axis=1, keepdims=True)
        jrh = rng.rand(17, V).astype(np.float32)
        jrh /= jrh.sum(axis=1, keepdims=True)
    return SMPLAssets(
        v_template=torch.from_numpy(v_template),
        shapedirs=torch.from_numpy(shapedirs),
        posedirs=torch.from_numpy(posedirs),
        j_regressor=torch.from_numpy(jr),
        lbs_weights=torch.from_numpy(w),
        parents=tuple(int(x) for x in C.SMPL_PARENTS),
        faces=torch.from_numpy(faces),
        extra_vertex_ids=extra_ids,
        j_regressor_extra=None if jre is None else torch.from_numpy(jre),
        j_regressor_h36m=None if jrh is None else torch.from_numpy(jrh),
    )


def load_assets_or_test(smpl_model_dir: str = '',
                        tag: str = 'smpl') -> SMPLAssets:
    """Neutral SMPL assets from the registry dir, or synthetic test
    assets (with a loud warning) when the released files are absent."""
    from spec_tpu_torch.utils import paths

    smpl_dir = smpl_model_dir or paths.smpl_model_dir()
    if os.path.isdir(smpl_dir) and os.listdir(smpl_dir):
        return load_smpl_assets(
            smpl_dir, gender='neutral',
            j_regressor_extra_path=paths.j_regressor_extra_path(),
            j_regressor_h36m_path=paths.j_regressor_h36m_path())
    print(f'[{tag}] WARNING: SMPL assets not found at {smpl_dir}; '
          'using synthetic test assets (meshes will be meaningless)')
    return create_test_assets()


def with_packed_lbs(assets: SMPLAssets) -> SMPLAssets:
    """Copy of the assets carrying the fused-kernel operands, on the
    assets' device: every :func:`smpl_forward` over it then goes through
    the fused LBS kernel."""
    from spec_tpu_torch.ops.lbs import pack_lbs_operands

    return dataclasses.replace(
        assets, packed_lbs=pack_lbs_operands(assets).to(assets.device))


def fused_on(assets: SMPLAssets, device) -> SMPLAssets:
    """The assets on ``device`` with the fused-kernel operands attached
    (packed once): every SMPL forward of a step over them runs the fused
    LBS kernel on a card and its plain version on the CPU."""
    assets = assets.to(device)
    return assets if assets.packed_lbs is not None \
        else with_packed_lbs(assets)


# ---------------------------------------------------------------------------
# Forward (LBS)
# ---------------------------------------------------------------------------


@fp32_matmuls
def _rigid_transform_chain(rotmats: torch.Tensor, joints: torch.Tensor,
                           parents) -> torch.Tensor:
    """Per-joint world transforms along the kinematic tree.

    rotmats (B, J, 3, 3) local rotations (index 0 = global orient),
    joints (B, J, 3) rest joints -> (B, J, 4, 4).
    """
    B, J = rotmats.shape[:2]
    par = list(parents)
    parent_idx = device_constant(par[1:], joints.device, torch.long)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parent_idx]],
                    dim=1)
    bottom = device_constant([0.0, 0.0, 0.0, 1.0], rotmats.device,
                             rotmats.dtype).expand(B, 1, 4)

    def make_tf(R, t):
        return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom],
                         dim=-2)

    world = [make_tf(rotmats[:, 0], rel[:, 0])]
    for j in range(1, J):
        world.append(world[par[j]] @ make_tf(rotmats[:, j], rel[:, j]))
    return torch.stack(world, dim=1)


def _rest_corrected(world_tf: torch.Tensor,
                    joints_rest: torch.Tensor) -> torch.Tensor:
    """``A'_j = A_j - [0 | A_j[:3, :3] @ J_j]``: transforms that act on
    rest-frame vertex coordinates. (B, J, 4, 4) -> (B, J, 4, 4)."""
    correction = torch.einsum('bjxy,bjy->bjx', world_tf[..., :3, :3],
                              joints_rest)
    rel_tf = world_tf.clone()
    rel_tf[..., :3, 3] -= correction
    return rel_tf


@fp32_matmuls
def lbs(assets: SMPLAssets, betas: torch.Tensor, rotmats: torch.Tensor,
        pose2rot_input_is_aa: bool = False):
    """Shape + pose blendshapes, joint regression, linear blend skinning.

    betas (B, 10); rotmats (B, 24, 3, 3), or (B, 72) axis-angle if
    ``pose2rot_input_is_aa``. Returns (vertices (B, V, 3), posed joints
    (B, 24, 3), world transforms (B, 24, 4, 4)).
    """
    from spec_tpu_torch.core.geometry import rodrigues

    if pose2rot_input_is_aa:
        rotmats = rodrigues(rotmats.reshape(-1, 24, 3))
    betas = betas.float()
    rotmats = rotmats.float()
    Bn = betas.shape[0]
    V = assets.num_vertices
    J = assets.num_joints

    v_shaped = assets.v_template[None] + (betas @ assets.shapedirs).reshape(
        Bn, V, 3)
    joints_rest = torch.einsum('jv,bvc->bjc', assets.j_regressor, v_shaped)

    eye = torch.eye(3, dtype=torch.float32, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(Bn, (J - 1) * 9)
    v_posed = v_shaped + (pose_feat @ assets.posedirs).reshape(Bn, V, 3)

    world_tf = _rigid_transform_chain(rotmats, joints_rest, assets.parents)
    rel_tf = _rest_corrected(world_tf, joints_rest)

    T = torch.einsum('vj,bjpq->bvpq', assets.lbs_weights, rel_tf)
    verts = (torch.einsum('bvpq,bvq->bvp', T[..., :3, :3], v_posed)
             + T[..., :3, 3])
    return verts, world_tf[..., :3, 3], world_tf


@fp32_matmuls
def lbs_fused(assets: SMPLAssets, betas: torch.Tensor,
              rotmats: torch.Tensor, packed=None):
    """LBS with the fused vertex kernel (``ops/lbs.py``).

    Equivalent to :func:`lbs`; the kinematic chain stays in torch (tiny)
    and vertices go through one kernel. Rest joints come from the joint
    regressor pre-projected onto the shape blendshapes, so the (B, V, 3)
    shaped mesh is never built. ``packed`` is a cached
    :func:`~spec_tpu_torch.ops.lbs.pack_lbs_operands` result.
    """
    from spec_tpu_torch.ops.lbs import (
        fused_lbs_vertices,
        lbs_coeffs,
        pack_lbs_operands,
    )

    if packed is None:
        packed = pack_lbs_operands(assets).to(betas.device)
    betas = betas.float()
    rotmats = rotmats.float()
    Bn = betas.shape[0]
    J = assets.num_joints

    joints_rest = packed.joints_template[None] + (
        betas @ packed.shapedirs_j).reshape(Bn, J, 3)
    world_tf = _rigid_transform_chain(rotmats, joints_rest, assets.parents)
    rel_tf = _rest_corrected(world_tf, joints_rest)[..., :3, :].contiguous()

    coeffs = lbs_coeffs(betas, rotmats)
    verts = fused_lbs_vertices(packed, coeffs, rel_tf)
    return verts, world_tf[..., :3, 3], world_tf


def smpl_forward(
    assets: SMPLAssets,
    betas: torch.Tensor,
    body_pose: torch.Tensor,
    global_orient: torch.Tensor,
    transl: Optional[torch.Tensor] = None,
    pose2rot: bool = True,
    joint_set: str = 'smpl54',
    fused: Optional[bool] = None,
) -> SMPLOutput:
    """Canonical SMPL forward.

    betas (B, 10); body_pose (B, 23, 3) axis-angle if ``pose2rot`` else
    (B, 23, 3, 3); global_orient (B, 1, 3) or (B, 1, 3, 3); transl
    optional (B, 3). ``joint_set``: 'native' (24), 'smpl54' or 'spin49'
    (the 49-joint superset; needs ``j_regressor_extra``). ``fused``
    defaults to "the assets carry packed operands".
    """
    from spec_tpu_torch.core.geometry import rodrigues

    if pose2rot:
        rotmats = rodrigues(torch.cat([global_orient, body_pose], dim=1))
    else:
        rotmats = torch.cat([global_orient, body_pose], dim=1)

    if fused is None:
        fused = assets.packed_lbs is not None
    if fused:
        verts, joints24, world_tf = lbs_fused(
            assets, betas, rotmats, packed=assets.packed_lbs)
    else:
        verts, joints24, world_tf = lbs(assets, betas, rotmats)

    if joint_set == 'native':
        joints = joints24
    else:
        # The 54/49-joint supersets index up to slot 53: missing extra
        # rows must fail loudly, never be papered over by clamped
        # indices.
        if assets.j_regressor_extra is None or assets.extra_vertex_ids is None:
            missing = ('j_regressor_extra' if assets.j_regressor_extra is None
                       else 'extra_vertex_ids')
            raise ValueError(
                f'joint_set={joint_set!r} requires assets.{missing} '
                '(load assets with j_regressor_extra_path / default '
                'extra_vertex_ids)')
        with fp32_precision():
            extra = torch.einsum('jv,bvc->bjc', assets.j_regressor_extra,
                                 verts)
        extra_ids = device_constant(assets.extra_vertex_ids, verts.device,
                                    torch.long)
        joints = torch.cat([joints24, verts[:, extra_ids], extra], dim=1)
        if joint_set == 'spin49':
            joints = joints[:, device_constant(C.JOINT49_TO_SMPL54,
                                               joints.device, torch.long)]

    if transl is not None:
        t = transl[:, None, :]
        verts = verts + t
        joints = joints + t
        joints24 = joints24 + t

    return SMPLOutput(vertices=verts, joints=joints, joints_native=joints24,
                      global_transforms=world_tf)


def regress_h36m_joints(assets: SMPLAssets, vertices: torch.Tensor,
                        subset: str = 'j14') -> torch.Tensor:
    """H36M 17-joint regression from the mesh, then the eval protocol's
    selection: (B, V, 3) -> (B, 14, 3) ('j14') or (B, 17, 3) ('j17'),
    in exact fp32."""
    from spec_tpu_torch.eval.metrics import regress_h36m

    if assets.j_regressor_h36m is None:
        raise ValueError('regress_h36m_joints needs assets.j_regressor_h36m '
                         '(load the assets with j_regressor_h36m_path)')
    j17 = regress_h36m(vertices, assets.j_regressor_h36m)
    sel = C.H36M_TO_J17 if subset == 'j17' else C.H36M_TO_J14
    return j17[:, device_constant(sel, j17.device, torch.long)]
