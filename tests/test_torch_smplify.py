"""spec_tpu_torch.train.smplify and the trainer's RUN_SMPLIFY hook against
spec_tpu's, on the CPU.

The fitting problem of the reference's test (``tests/test_smplify.py``):
B = 4, synthetic SMPL with V = 256, 49 target keypoints projected from a
GT pose and the fit started from a perturbed one (pose noise 0.15, root
0.1, translation 0.2), the reference's default energy weights and
``lr`` 1e-2. The port's SMPL forwards go through K1's plain version
(packed assets), the JAX side through its plain LBS.

Limits (fp32 on both sides):
* step by step, after 1, 2 and 3 Adam steps: every fitted parameter
  within 1e-5 absolute (PARAM_ATOL; read: 3e-7), the vertices within
  1e-5 m, the reprojection loss within 1e-5 relative (REPROJ_RTOL).
  Adam's first step moves each entry by about +-lr whatever its
  gradient's size, so a gradient that differed in sign would show here
  as an error of 2e-2;
* at the default 100 iterations: only the per-sample final reprojection
  loss, within 1e-4 relative (REPROJ_100_RTOL; read: 3e-6), and the
  acceptance mask of ``apply_smplify_update``, equal, at a threshold
  that takes some samples and refuses others.
* the trainer hook (ResNet-18 HMR, weights bridged from the JAX init,
  three iterations, everything accepted): the swapped-in pose and betas
  within 1e-4 absolute (HOOK_ATOL).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spec_tpu.core import smpl as JS
from spec_tpu.train import smplify as JF
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.train import smplify as TF
from spec_tpu_torch.utils.checkpoints import assets_from_jax

PARAM_ATOL, VERT_ATOL, REPROJ_RTOL = 1e-5, 1e-5, 1e-5
REPROJ_100_RTOL = 1e-4
HOOK_ATOL = 1e-4
B, V = 4, 256


def _project_np(joints, cam_t, R, K):
    pts = joints @ R.T + cam_t
    proj = pts @ K.T
    return proj[:, :2] / proj[:, 2:3]


@pytest.fixture(scope='module')
def problem():
    rng = np.random.RandomState(0)
    jassets = JS.create_test_assets(num_vertices=V)
    gt_go = rng.randn(B, 1, 3).astype('f4') * 0.2
    gt_bp = rng.randn(B, 23, 3).astype('f4') * 0.2
    gt_betas = rng.randn(B, 10).astype('f4') * 0.5
    gt_t = np.tile(np.array([[0.0, 0.0, 5.0]], 'f4'), (B, 1))
    R = np.tile(np.eye(3, dtype='f4'), (B, 1, 1))
    K = np.tile(np.array([[1000.0, 0, 500], [0, 1000.0, 500],
                          [0, 0, 1]], 'f4'), (B, 1, 1))
    joints = np.asarray(JS.smpl_forward(
        jassets, jnp.asarray(gt_betas), jnp.asarray(gt_bp),
        jnp.asarray(gt_go), pose2rot=True, joint_set='spin49').joints)
    kp = np.stack([np.concatenate(
        [_project_np(joints[b], gt_t[b], R[b], K[b]),
         np.ones((49, 1), 'f4')], -1) for b in range(B)]).astype('f4')
    init = [gt_go + rng.randn(*gt_go.shape).astype('f4') * 0.1,
            gt_bp + rng.randn(*gt_bp.shape).astype('f4') * 0.15,
            np.zeros((B, 10), 'f4'),
            gt_t + rng.randn(B, 3).astype('f4') * 0.2]
    args = init + [kp, R, K]
    return jassets, S.with_packed_lbs(assets_from_jax(jassets)), args


def _fits(problem, **kw):
    jassets, tassets, args = problem
    want = JF.smplify_fit(jassets, *[jnp.asarray(a) for a in args], **kw)
    got = TF.smplify_fit(tassets, *[torch.from_numpy(a) for a in args],
                         **kw)
    return got, want


def test_gmof_and_angle_prior_match():
    x = np.array([0.0, 1.0, -3.0, 250.0, 1e6], 'f4')
    np.testing.assert_allclose(TF.gmof(torch.from_numpy(x), 100.0).numpy(),
                               np.asarray(JF.gmof(jnp.asarray(x), 100.0)),
                               rtol=1e-6)
    bp = np.random.RandomState(1).randn(3, 23, 3).astype('f4')
    np.testing.assert_allclose(
        TF.angle_prior(torch.from_numpy(bp)).numpy(),
        np.asarray(JF.angle_prior(jnp.asarray(bp))), rtol=1e-6)
    assert TF.angle_prior(torch.zeros(2, 23, 3)).shape == (2, 4)

    def cost(j, c, val):
        p = torch.zeros(1, 23, 3)
        p[0, j - 1, c] = val
        return float(TF.angle_prior(p).sum())

    assert cost(4, 0, -1.0) > cost(4, 0, 1.0)     # L knee
    assert cost(5, 0, -1.0) > cost(5, 0, 1.0)     # R knee
    assert cost(18, 1, 1.0) > cost(18, 1, -1.0)   # L elbow
    assert cost(19, 1, -1.0) > cost(19, 1, 1.0)   # R elbow


@pytest.mark.parametrize('num_iters', [1, 2, 3])
def test_fit_matches_jax_step_by_step(problem, num_iters):
    got, want = _fits(problem, num_iters=num_iters)
    assert isinstance(got, TF.SMPLifyResult)
    for name in ('global_orient', 'body_pose', 'betas', 'cam_t'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
    np.testing.assert_allclose(got.vertices.numpy(),
                               np.asarray(want.vertices), rtol=0,
                               atol=VERT_ATOL)
    np.testing.assert_allclose(got.reproj_loss.numpy(),
                               np.asarray(want.reproj_loss),
                               rtol=REPROJ_RTOL)


def test_fit_at_100_iterations_matches_loss_and_acceptance(problem):
    got, want = _fits(problem)
    g = got.reproj_loss.numpy()
    w = np.asarray(want.reproj_loss)
    np.testing.assert_allclose(g, w, rtol=REPROJ_100_RTOL)
    per_joint = w / 49.0
    threshold = float(np.median(per_joint))
    batch = {'pose': np.zeros((B, 72), 'f4'), 'betas': np.zeros((B, 10), 'f4'),
             'has_smpl': np.zeros(B, 'f4'),
             'keypoints_orig': problem[2][4]}
    mask = TF.apply_smplify_update(batch, got, threshold)['has_smpl']
    want_mask = JF.apply_smplify_update(batch, want, threshold)['has_smpl']
    np.testing.assert_array_equal(mask, want_mask)
    assert 0 < mask.sum() < B
    # the fit moved the keypoints' error down from the start
    start = TF.smplify_fit(problem[1], *[torch.from_numpy(a)
                                         for a in problem[2]], num_iters=0)
    assert (g < start.reproj_loss.numpy()).all()


def test_fit_recovers_a_perturbed_pose(problem):
    """The reference's recovery check: 150 steps at lr 2e-2 with weak
    priors cut the mean pixel error to under 0.35 of the start's."""
    _, tassets, args = problem
    targs = [torch.from_numpy(a) for a in args]
    res = TF.smplify_fit(tassets, *targs, num_iters=150, lr=2e-2,
                         pose_prior_weight=1.0, shape_prior_weight=1.0,
                         angle_prior_weight=0.0)
    kp, R, K = args[4], args[5], args[6]

    def err(go, bp, betas, t):
        j = S.smpl_forward(tassets, betas, bp, go, pose2rot=True,
                           joint_set='spin49').joints.numpy()
        return np.stack([np.linalg.norm(_project_np(j[b], t[b], R[b], K[b])
                                         - kp[b, :, :2], axis=-1).mean()
                         for b in range(B)])

    with torch.no_grad():
        before = err(targs[0], targs[1], targs[2], args[3])
        after = err(res.global_orient, res.body_pose, res.betas,
                    res.cam_t.numpy())
    assert (after < before * 0.35).all(), (before, after)


def test_packed_and_plain_assets_agree(problem):
    """K1's plain version and the plain LBS give the same fit: every
    field within 1e-5 absolute, the reprojection loss (up to 1.1e5 px^2
    here) within REPROJ_RTOL."""
    jassets, tassets, args = problem
    targs = [torch.from_numpy(a) for a in args]
    a = TF.smplify_fit(tassets, *targs, num_iters=5)
    b = TF.smplify_fit(assets_from_jax(jassets), *targs, num_iters=5)
    for name, x, y in zip(TF.SMPLifyResult._fields, a, b):
        np.testing.assert_allclose(
            x.numpy(), y.numpy(), err_msg=name,
            rtol=REPROJ_RTOL if name == 'reproj_loss' else 0,
            atol=0 if name == 'reproj_loss' else 1e-5)


def test_apply_smplify_update_matches():
    """The reference test's four cases, on numpy arrays and tensors."""
    kp_conf = np.ones((B, 49, 1), 'f4')
    kp_conf[3] = 0.0
    batch = {
        'pose': np.zeros((B, 72), 'f4'),
        'betas': np.zeros((B, 10), 'f4'),
        'has_smpl': np.array([0.0, 1.0, 0.0, 0.0], 'f4'),
        'keypoints_orig': np.concatenate([np.zeros((B, 49, 2), 'f4'),
                                          kp_conf], -1),
    }
    fields = dict(global_orient=np.full((B, 1, 3), 0.5, 'f4'),
                  body_pose=np.full((B, 23, 3), 0.25, 'f4'),
                  betas=np.full((B, 10), 2.0, 'f4'),
                  cam_t=np.zeros((B, 3), 'f4'),
                  reproj_loss=np.array([49 * 5.0, 49 * 5.0, 49 * 500.0, 0.0],
                                       'f4'),
                  vertices=np.zeros((B, 8, 3), 'f4'))
    want = JF.apply_smplify_update(batch, JF.SMPLifyResult(**fields), 100.0)
    for as_tensor in (False, True):
        conv = torch.from_numpy if as_tensor else (lambda x: x)
        res = TF.SMPLifyResult(**{k: conv(v) for k, v in fields.items()})
        got = TF.apply_smplify_update(
            {k: conv(v) for k, v in batch.items()}, res, 100.0)
        for k in ('pose', 'betas', 'has_smpl'):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['has_smpl'], [1.0, 1.0, 0.0, 0.0])
    assert batch['has_smpl'][0] == 0.0


def test_fit_body_is_capturable(problem):
    """The fit's body (Adam steps over the energy's gradient, the final
    forward) builds no tensor from host data and reads nothing back
    after a warm-up call (what a CUDA graph capture refuses)."""
    from tests.test_torch_graphs import _uncapturable_ops

    _, tassets, args = problem
    body = functools.partial(
        TF._fit_body, tassets, num_iters=2, lr=1e-2, sigma=100.0,
        pose_prior_weight=4.78, shape_prior_weight=5.0,
        angle_prior_weight=15.2, joint_set='spin49')
    seen = _uncapturable_ops(body, *[torch.from_numpy(a) for a in args])
    assert not seen, seen


def _hook_setup(rng):
    from spec_tpu.core import geometry as G
    from spec_tpu.models import HMR as JaxHMR
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    Bh, res = 4, 64
    jassets = JS.create_test_assets(num_vertices=128)
    jmodel = JaxHMR(backbone='resnet18', use_cam=True, use_cam_feats=False)
    images = rng.randn(Bh, res, res, 3).astype('f4')
    R = np.asarray(G.euler_to_rotmat(jnp.asarray(
        rng.randn(Bh, 3).astype('f4') * 0.1)))
    w = np.full((Bh,), 640.0, 'f4')
    h = np.full((Bh,), 480.0, 'f4')
    K = np.asarray(G.build_cam_intrinsics(jnp.full((Bh,), 800.0),
                                          jnp.asarray(w), jnp.asarray(h)))
    center = rng.rand(Bh, 2).astype('f4') * 200 + 100
    scale = rng.rand(Bh).astype('f4') + 1.0
    variables = jmodel.init(jax.random.PRNGKey(0), jassets,
                            jnp.asarray(images), jnp.asarray(R),
                            jnp.asarray(K), jnp.asarray(scale),
                            jnp.asarray(center), jnp.asarray(w),
                            jnp.asarray(h))
    port = HMR(backbone='resnet18', use_cam=True, use_cam_feats=False)
    port.load_state_dict(state_dict_from_flax(variables, 'hmr', 'resnet18'))
    dev = {
        'img': images,
        'pose': np.zeros((Bh, 72), 'f4'),
        'betas': np.zeros((Bh, 10), 'f4'),
        'has_smpl': np.zeros((Bh,), 'f4'),
        'keypoints_orig': np.concatenate(
            [rng.rand(Bh, 49, 2).astype('f4') * 400,
             np.ones((Bh, 49, 1), 'f4')], -1),
        'orig_shape': np.tile(np.array([[480.0, 640.0]], 'f4'), (Bh, 1)),
        'scale': scale, 'center': center,
        'cam_rotmat': R, 'cam_intrinsics': K,
    }
    return jmodel, variables, jassets, port, dev


def _smplify_cfg(make):
    cfg = make()
    cfg.LOGDIR = ''
    cfg.TRAINING.RUN_SMPLIFY = True
    cfg.TRAINING.NUM_SMPLIFY_ITERS = 3
    cfg.TRAINING.SMPLIFY_THRESHOLD = 1e9      # accept everything
    return cfg


def test_trainer_hook_matches_jax(rng):
    """SpecTrainer._run_smplify: predict in eval mode, fit, swap in."""
    from spec_tpu.train.trainer import SpecTrainer as JaxTrainer
    from spec_tpu.utils.config import spec_default_config as jax_cfg
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    jmodel, variables, jassets, port, dev = _hook_setup(rng)
    jtrainer = JaxTrainer(
        _smplify_cfg(jax_cfg), jmodel, {'neutral': jassets},
        np.asarray(jassets.j_regressor_h36m), lambda e: None, lambda: {},
        init_variables=variables)
    want = jtrainer._run_smplify({k: jnp.asarray(v) if k in (
        'img', 'cam_rotmat', 'cam_intrinsics', 'scale', 'center')
        else v for k, v in dev.items()})
    tassets = assets_from_jax(jassets)
    trainer = SpecTrainer(
        _smplify_cfg(spec_default_config), port.train(),
        {'neutral': tassets}, tassets.j_regressor_h36m.numpy(),
        lambda e: None, lambda: {})
    tdev = {k: torch.from_numpy(v) for k, v in dev.items()}
    got = trainer._run_smplify(tdev)
    assert port.training                   # back in train mode
    assert isinstance(got['pose'], torch.Tensor)
    np.testing.assert_allclose(got['has_smpl'].numpy(), 1.0)
    for k in ('pose', 'betas'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=HOOK_ATOL, err_msg=k)
    assert not np.allclose(got['pose'].numpy(), 0.0)
    assert torch.equal(tdev['pose'], torch.zeros(4, 72))   # untouched


def test_trainer_fit_runs_the_hook(rng, monkeypatch, tmp_path):
    """With RUN_SMPLIFY the fit calls the hook before every step and logs
    its time."""
    from spec_tpu_torch.bench import train_inputs
    from spec_tpu_torch.train.trainer import SpecTrainer
    from spec_tpu_torch.utils.config import spec_default_config

    _, _, jassets, port, _ = _hook_setup(rng)
    tassets = assets_from_jax(jassets)
    cfg = _smplify_cfg(spec_default_config)
    cfg.LOGDIR = str(tmp_path)
    cfg.LOG_FREQ_TB_IMAGES = 0
    cfg.SEED_VALUE = 0
    cfg.DATASET.BATCH_SIZE = 2
    cfg.DATASET.NUM_WORKERS = 0
    cfg.TRAINING.LOG_SAVE_INTERVAL = 1
    arrays = train_inputs(4, 64, seed=1)
    arrays['cam_int'] = arrays.pop('cam_intrinsics')
    arrays['has_smpl'][:] = 0.0

    class Items:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {k: v[i] for k, v in arrays.items()}

    trainer = SpecTrainer(cfg, port.train(), {'neutral': tassets},
                          tassets.j_regressor_h36m.numpy(),
                          lambda e: Items(), lambda: {})
    calls = []
    hook = trainer._run_smplify
    monkeypatch.setattr(trainer, '_run_smplify',
                        lambda dev: calls.append(1) or hook(dev))
    trainer.fit(max_epochs=1)
    assert len(calls) == 2 and trainer.state.step == 2
