"""The port's training stack learns: ``tests/test_learning.py``'s two
checks, ported with the reference's recipes and limits.

* **Horizon.** CamCalib's job is to read the horizon from the image. A
  ResNet-18 CamCalib trains on 160 synthetic 64x64 frames whose only
  signal is a pitch/roll-determined horizon
  (``datagen.synthetic.render_horizon_batch``, vfov 1.2), B = 32 for 8
  epochs, Adam at 3e-4 (the camcalib config's optimizer), 'ce' loss,
  through ``train.make_camcalib_train_step``. The late loss must fall
  under 0.6 of the early loss, and the pitch and roll MAE on 64
  held-out frames under 0.6 of the random init's and under 0.15 rad.
* **Memorization.** The SPEC step (HMR ResNet-18 with the camera and
  camera features, ``HMRCamLoss``, both SMPL forwards through K1's op)
  on the reference's fixed batch of 4 (V = 64 test assets), Adam at
  2e-4 for 8 steps: finite losses, the mean of the last two under 0.85
  of the mean of the first two.

Each check also runs at lr 0, where the same limits must refuse it: the
limits see learning, not BatchNorm's running statistics moving or
dropout's noise. The reference seeds its data with the suite's
``RandomState(42)`` (``tests/conftest.py``), as here. The horizon check
starts from the reference's own init (see ``JAX_HORIZON`` for the
card's draws); the SPEC step from the port's random init.

This file imports no JAX: ``chip_smoke.py`` phase 26 imports its checks
by module name (``tests/`` on ``sys.path``) and runs them on the card,
where every step replays a CUDA graph.
"""

import numpy as np
import pytest
import torch

RES = 64
VFOV = 1.2     # fixed: a bare horizon line does not identify the vfov
HORIZON = dict(n_train=160, n_val=64, batch=32, epochs=8, lr=3e-4)
MEMORIZE = dict(batch=4, vertices=64, steps=8, lr=2e-4)
SEED = 42      # the suite's rng fixture
# The recipe's held-out limit of 0.15 rad lies inside the spread of
# random inits, in the JAX package as in the port, so one init's pass
# says little. ``python tests/test_torch_learning.py`` runs the recipe on
# the CPU from PRNGKeys 0-11 in the JAX package and in the port (the same
# inits through state_dict_from_flax), and from flax_init draws 0-11 in
# the port: JAX_HORIZON holds the JAX package's mean and deviation of
# the held-out MAE over its twelve keys. Tier-1 runs the reference's own
# init (PRNGKey(0)). The card, which has no JAX, runs HORIZON_DRAWS
# flax_init draws and holds them as a set to JAX_HORIZON
# (horizon_set_misses).
HORIZON_DRAWS = 12
# held-out (pitch, roll) MAE in rad of the init and after the recipe,
# the JAX package from PRNGKeys 0-11 on the CPU (the script above)
JAX_HORIZON_MAE = (
    ((0.2417, 0.2573), (0.0441, 0.1097)), ((0.1836, 0.5223), (0.0366, 0.1852)),
    ((0.2754, 0.7165), (0.1040, 0.1508)), ((0.5054, 0.1729), (0.0312, 0.0964)),
    ((0.4194, 0.4725), (0.0908, 0.1994)), ((0.2222, 0.5656), (0.0252, 0.0772)),
    ((0.5007, 0.1957), (0.0311, 0.0831)), ((0.1846, 0.2331), (0.0293, 0.1938)),
    ((0.4240, 0.4844), (0.0301, 0.0762)), ((0.2032, 0.8299), (0.0380, 0.0852)),
    ((0.3039, 0.4681), (0.0395, 0.0826)), ((0.2703, 0.7959), (0.0949, 0.2266)))
JAX_HORIZON = dict(
    keys=len(JAX_HORIZON_MAE),
    # keys meeting every per-run limit (each meets the loss limit)
    meet=sum(max(m) < 0.15 and all(a < 0.6 * b for a, b in zip(m, m0))
             for m0, m in JAX_HORIZON_MAE),
    **{name: (float(np.mean(col)), float(np.std(col, ddof=1)))
       for name, col in zip(('pitch', 'roll'),
                            zip(*(m for _, m in JAX_HORIZON_MAE)))})


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: whole models under a parallel test run (see
    tests/test_torch_detector.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@torch.no_grad()
def flax_init(model: torch.nn.Module, seed: int = 0) -> None:
    """The JAX package's random init, drawn in torch: every conv's kernel
    from flax's default (``lecun_normal``: a normal truncated at two
    deviations, variance 1 / fan_in), BatchNorm's scale 1 and shift 0,
    each one-layer CamCalib head N(0, 0.01) with zero bias (the JAX
    module's). The port's own ``reset_parameters`` draws torchvision's
    (Kaiming, fan_out), whose larger activations leave the horizon
    recipe's 40 steps short of the limits the reference's init meets."""
    g = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                        2 * std, generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, torch.nn.Linear) and name.startswith('fc_'):
            m.weight.normal_(0.0, 0.01, generator=g)
            m.bias.zero_()


def _pitch_roll_mae(model, imgs, pitch, roll):
    from spec_tpu_torch.core import bins as B

    model.eval()
    with torch.no_grad():
        logits = model(imgs)
        _, p, r = B.convert_preds_to_angles(*logits, loss_type='ce')
    model.train()
    return (float(np.abs(p.cpu().numpy() - pitch).mean()),
            float(np.abs(r.cpu().numpy() - roll).mean()))


def horizon_run(device='cpu', lr=HORIZON['lr'], init=0,
                seed=SEED) -> dict:
    """The horizon recipe on ``device`` from ``init`` (a CamCalib
    state_dict, or the seed of a :func:`flax_init` draw): the losses of
    every step and the held-out pitch and roll MAE before and after."""
    from spec_tpu_torch.data.pano_dataset import encode_targets
    from spec_tpu_torch.datagen.synthetic import render_horizon_batch
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork
    from spec_tpu_torch.train import (
        create_train_state,
        make_camcalib_train_step,
        make_optimizer,
    )
    from spec_tpu_torch.utils.config import camcalib_default_config

    rng = np.random.RandomState(seed)
    cfg = camcalib_default_config()
    cfg.OPTIMIZER.LR = lr
    imgs, pitch, roll = render_horizon_batch(rng, HORIZON['n_train'],
                                             res=RES, vfov=VFOV)
    val = render_horizon_batch(rng, HORIZON['n_val'], res=RES, vfov=VFOV)
    val_imgs = torch.from_numpy(val[0]).to(device)

    model = CameraRegressorNetwork(backbone='resnet18')
    if isinstance(init, dict):
        model.load_state_dict(init)
    else:
        flax_init(model, init)
    model.to(device)
    state = create_train_state(model, make_optimizer(cfg.OPTIMIZER))
    step = make_camcalib_train_step(model, loss_type='ce')
    mae0 = _pitch_roll_mae(model, val_imgs, *val[1:])

    enc = encode_targets(np.full(len(pitch), VFOV, np.float32), pitch,
                         roll, 'ce')
    targets = {k: torch.from_numpy(np.asarray(enc[k])).to(device)
               for k in ('vfov', 'pitch', 'roll')}
    imgs_dev = torch.from_numpy(imgs).to(device)
    losses = []
    for _ in range(HORIZON['epochs']):
        order = rng.permutation(len(imgs))
        for s in range(0, len(imgs), HORIZON['batch']):
            idx = torch.from_numpy(order[s:s + HORIZON['batch']]).to(device)
            batch = {'img': imgs_dev[idx],
                     **{k: v[idx] for k, v in targets.items()}}
            state, m = step(state, batch)
            losses.append(float(m['loss']))
    return dict(losses=losses, mae0=mae0,
                mae=_pitch_roll_mae(model, val_imgs, *val[1:]))


def horizon_misses(r: dict) -> list:
    """The reference's limits the horizon run misses (none: it learned)."""
    early, late = np.mean(r['losses'][:4]), np.mean(r['losses'][-4:])
    (p0, r0), (p, q) = r['mae0'], r['mae']
    checks = {f'late loss {late:.4f} < 0.6 x early {early:.4f}':
              late < 0.6 * early,
              f'pitch MAE {p:.4f} < 0.6 x init {p0:.4f}': p < 0.6 * p0,
              f'roll MAE {q:.4f} < 0.6 x init {r0:.4f}': q < 0.6 * r0,
              f'pitch MAE {p:.4f} < 0.15 rad': p < 0.15,
              f'roll MAE {q:.4f} < 0.15 rad': q < 0.15}
    return [k for k, ok in checks.items() if not ok]


def horizon_set_misses(runs: list) -> list:
    """The limits a set of horizon runs from independent inits misses,
    the recipe's limits taken over the set and held to the JAX package's
    keys: every run's late loss under 0.6 of its early loss; the mean
    held-out pitch and roll MAE under 0.6 of the mean init's, and under
    JAX's mean plus two standard errors of the difference of the two
    means (JAX_HORIZON). The JAX package itself misses the per-run
    0.15 rad and 0.6 x init limits from some keys."""
    misses = [f'run {i}: {m}' for i, r in enumerate(runs)
              for m in horizon_misses(r) if m.startswith('late loss')]
    for j, name in enumerate(('pitch', 'roll')):
        mean = float(np.mean([r['mae'][j] for r in runs]))
        mean0 = float(np.mean([r['mae0'][j] for r in runs]))
        want, sd = JAX_HORIZON[name]
        limit = want + 2 * sd * (1 / JAX_HORIZON['keys']
                                 + 1 / len(runs)) ** 0.5
        if not mean < 0.6 * mean0:
            misses.append(f'mean {name} MAE {mean:.4f} < 0.6 x mean init '
                          f'{mean0:.4f}')
        if not mean < limit:
            misses.append(f'mean {name} MAE {mean:.4f} < {limit:.4f} (JAX '
                          f'{want:.4f} + two standard errors)')
    return misses


def memorize_batch(rng, device='cpu') -> dict:
    """``tests/test_learning.py``'s fixed SPEC batch, drawn in its order
    from ``rng``."""
    from spec_tpu_torch.core import geometry as G

    B = MEMORIZE['batch']
    images = torch.from_numpy(rng.randn(B, 64, 64, 3).astype('f4'))
    cam_rotmat = G.euler_to_rotmat(
        torch.from_numpy(rng.randn(B, 3).astype('f4') * 0.1))
    img_w = torch.full((B,), 1920.0)
    img_h = torch.full((B,), 1080.0)
    K = G.build_cam_intrinsics(torch.full((B,), 1500.0), img_w, img_h)
    center = torch.from_numpy(rng.rand(B, 2).astype('f4') * 800 + 300)
    scale = torch.from_numpy(rng.rand(B).astype('f4') + 1.0)
    batch = {
        'img': images,
        'pose': torch.from_numpy(rng.randn(B, 72).astype('f4') * 0.2),
        'betas': torch.from_numpy(rng.randn(B, 10).astype('f4') * 0.3),
        'pose_conf': torch.ones(B, 24),
        'pose_3d': torch.from_numpy(rng.randn(B, 24, 4).astype('f4')),
        'keypoints_orig': torch.from_numpy(np.concatenate(
            [rng.rand(B, 49, 2) * 1000, np.ones((B, 49, 1))],
            -1).astype('f4')),
        'has_smpl': torch.ones(B),
        'has_pose_3d': torch.ones(B),
        'orig_shape': torch.from_numpy(
            np.tile(np.array([[1080.0, 1920.0]], 'f4'), (B, 1))),
        'scale': scale,
        'center': center,
        'cam_rotmat': cam_rotmat,
        'cam_intrinsics': K,
    }
    return {k: v.to(device) for k, v in batch.items()}


def memorize_run(device='cpu', lr=MEMORIZE['lr'], seed=SEED) -> dict:
    """The memorization recipe on ``device``: the total loss of every
    step."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.models.hmr import HMR
    from spec_tpu_torch.train import (
        adam,
        create_train_state,
        make_spec_train_step,
    )

    assets = S.create_test_assets(num_vertices=MEMORIZE['vertices'])
    model = HMR(backbone='resnet18', use_cam=True, use_cam_feats=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    batch = memorize_batch(np.random.RandomState(seed), device)
    step = make_spec_train_step(model, assets)
    state = create_train_state(model, adam(lr))
    gen = torch.Generator(device=device).manual_seed(1)      # dropout
    losses = []
    for _ in range(MEMORIZE['steps']):
        state, m = step(state, batch, gen)
        losses.append(float(m['loss/total_loss']))
    return dict(losses=losses)


def memorize_misses(r: dict) -> list:
    """The reference's limits the memorization run misses."""
    losses = r['losses']
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    checks = {'every loss finite': all(np.isfinite(v) for v in losses),
              f'last two {last:.4f} < 0.85 x first two {first:.4f}':
              last < 0.85 * first}
    return [k for k, ok in checks.items() if not ok]


def _jax_variables(key: int):
    import jax
    import jax.numpy as jnp

    from spec_tpu.models import CameraRegressorNetwork as JaxCamCalib

    model = JaxCamCalib(backbone='resnet18')
    return model, model.init(jax.random.PRNGKey(key),
                             jnp.zeros((2, RES, RES, 3)))


def reference_init(key: int = 0) -> dict:
    """The reference test's init: the JAX package's ResNet-18 CamCalib
    from ``PRNGKey(key)`` (the test's is 0), through
    ``state_dict_from_flax``."""
    import jax

    from spec_tpu_torch.utils.checkpoints import state_dict_from_flax

    return state_dict_from_flax(jax.device_get(_jax_variables(key)[1]),
                                'camcalib', 'resnet18')


def jax_horizon_run(key: int = 0, seed=SEED) -> dict:
    """``tests/test_learning.py``'s horizon recipe in the JAX package from
    ``PRNGKey(key)``, the same data and order as :func:`horizon_run`."""
    import jax
    import jax.numpy as jnp

    from spec_tpu.core import bins as JB
    from spec_tpu.data.pano_dataset import encode_targets
    from spec_tpu.datagen.synthetic import render_horizon_batch
    from spec_tpu.train import (
        create_train_state,
        make_camcalib_train_step,
        make_optimizer,
    )
    from spec_tpu.utils.config import camcalib_default_config

    rng = np.random.RandomState(seed)
    cfg = camcalib_default_config()
    cfg.OPTIMIZER.LR = HORIZON['lr']
    tx = make_optimizer(cfg.OPTIMIZER)
    imgs, pitch, roll = render_horizon_batch(rng, HORIZON['n_train'],
                                             res=RES, vfov=VFOV)
    val = render_horizon_batch(rng, HORIZON['n_val'], res=RES, vfov=VFOV)
    model, variables = _jax_variables(key)
    state = create_train_state(variables, tx)
    step = jax.jit(make_camcalib_train_step(model, tx, loss_type='ce'))

    def mae(state):
        logits = model.apply({'params': state.params,
                              'batch_stats': state.batch_stats},
                             jnp.asarray(val[0]), train=False)
        _, p, r = JB.convert_preds_to_angles(*logits, loss_type='ce')
        return (float(np.abs(np.asarray(p) - val[1]).mean()),
                float(np.abs(np.asarray(r) - val[2]).mean()))

    mae0 = mae(state)
    enc = encode_targets(np.full(len(pitch), VFOV, np.float32), pitch,
                         roll, 'ce')
    losses = []
    for _ in range(HORIZON['epochs']):
        order = rng.permutation(len(imgs))
        for s in range(0, len(imgs), HORIZON['batch']):
            idx = order[s:s + HORIZON['batch']]
            state, m = step(state, {'img': jnp.asarray(imgs[idx]),
                                    **{k: jnp.asarray(enc[k][idx])
                                       for k in ('vfov', 'pitch', 'roll')}})
            losses.append(float(m['loss']))
    return dict(losses=losses, mae0=mae0, mae=mae(state))


@pytest.mark.parametrize('init,lr', [('reference', HORIZON['lr']),
                                     ('reference', 0.0)])
def test_camcalib_learns_horizon_generalization(init, lr):
    """From the reference's init at the recipe's lr the run meets every
    limit; at lr 0 (the same data, steps and BatchNorm statistics, no
    update) it misses them all."""
    r = horizon_run(lr=lr, init=reference_init())
    misses = horizon_misses(r)
    print(f'[learning] {init} init, lr {lr:g}: loss '
          f'{np.mean(r["losses"][:4]):.4f} -> '
          f'{np.mean(r["losses"][-4:]):.4f}; held-out MAE pitch '
          f'{r["mae0"][0]:.4f} -> {r["mae"][0]:.4f}, roll {r["mae0"][1]:.4f} '
          f'-> {r["mae"][1]:.4f} rad; missed: {misses}')
    if lr:
        assert not misses, misses
    else:
        assert len(misses) == 5, misses


def test_flax_init_draws_the_reference_init():
    """:func:`flax_init` draws from the JAX package's init: against
    ``PRNGKey(0)``'s ResNet-18 CamCalib, every tensor of the same shape,
    every drawn one with a deviation within 3 % of JAX's (the smallest
    has 9408 draws: 0.7 % of sampling error), every convolution inside
    the same truncation, every constant one equal."""
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork

    want = reference_init()
    model = CameraRegressorNetwork(backbone='resnet18')
    flax_init(model, 0)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    drawn = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.is_floating_point() and w.numel() > 1 and float(w.std()) > 0:
            drawn += 1
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.03, k
            if w.dim() == 4:       # lecun_normal: cut at two deviations
                cut = 2 * (1 / w[0].numel()) ** 0.5 / .87962566103423978
                assert max(float(g.abs().max()),
                           float(w.abs().max())) <= cut * (1 + 1e-6), k
        else:
            assert torch.equal(g, w.to(g.dtype)), k
    assert drawn == 23         # 20 convolutions, 3 heads


@pytest.mark.parametrize('lr', [MEMORIZE['lr'], 0.0])
def test_spec_train_step_memorizes_fixed_batch(lr):
    r = memorize_run(lr=lr)
    misses = memorize_misses(r)
    print(f'[learning] lr {lr:g}: losses {r["losses"]}; missed: {misses}')
    if lr:
        assert not misses, misses
    else:
        assert misses == [m for m in misses if m.startswith('last two')] \
            and len(misses) == 1, misses


if __name__ == '__main__':
    # the horizon recipe on the CPU, for k in range(FIRST, END) (the
    # arguments; 0 and HORIZON_DRAWS by default): the JAX package from
    # PRNGKey(k) and the port from that init, then the port from
    # flax_init draw k
    import sys

    torch.set_num_threads(1)
    first, end = map(int, sys.argv[1:3]) if sys.argv[2:] else (
        0, HORIZON_DRAWS)

    def show(label, r):
        print(f'{label}: pitch MAE {r["mae0"][0]:.4f} -> {r["mae"][0]:.4f}, '
              f'roll {r["mae0"][1]:.4f} -> {r["mae"][1]:.4f} rad; missed: '
              f'{horizon_misses(r)}', flush=True)

    for k in range(first, end):
        show(f'JAX PRNGKey({k})', jax_horizon_run(k))
        show(f'port from PRNGKey({k})', horizon_run(init=reference_init(k)))
    for k in range(first, end):
        show(f'port flax_init draw {k}', horizon_run(init=k))
