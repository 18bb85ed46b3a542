"""Train step factories for SPEC and CamCalib (torch twin of
``spec_tpu/train/steps.py``).

``step(state, batch, generator=None) -> (state, metrics)``: the forward
in train mode, the loss (exact fp32, outside autocast), the backward and
the optimizer update, in place on ``state`` (the JAX step donates its
state). The SPEC step runs the GT SMPL on the device inside the step and
teacher-forces the GT camera; the head's dropout draws from
``generator``.

On the card each step is **one CUDA graph replay** per batch signature,
the counterpart of the reference's ``jax.jit(step, donate_argnums=0)``
(a ``utils/graphs.StageGraph`` over the step body, recording autograd);
on the CPU the body runs directly. The first call of a signature takes
its step eagerly and captures the graph; a capture that fails raises.
The dropout generator is registered with the graph, so each replay
draws new masks. With ``GRAD_ACCUM_STEPS = k > 1`` there are two graphs
per signature: the accumulating micro-step and the micro-step that also
updates, each in a memory pool of its own (they replay in no fixed
order).

Data parallel (one process per GPU, ``parallel.initialize_multihost``):
each rank steps on its slice of the global batch. The body runs in
``parallel.sharded_batch``, so the losses and BatchNorm reduce over the
global batch, and between the backward and the update the gradients are
summed over the ranks in one flat buffer and the metrics made global.
The parameters are broadcast from rank 0 when a state is first bound.
Under NCCL the step, its collectives included, stays one graph replay;
under gloo, whose collectives cannot be captured, it runs its eager body
(:attr:`TrainStep.mode` says which).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.losses import (
    HMRLossConfig,
    camera_regressor_loss,
    hmr_cam_loss,
)
from spec_tpu_torch.ops.preprocess import device_jitter_normalize
from spec_tpu_torch.train.state import TrainState
from spec_tpu_torch.utils import profiling
from spec_tpu_torch.utils.graphs import StageGraph
from spec_tpu_torch.utils.precision import fp32_precision

# The SPEC step's batch contract, in the order its graph takes it.
SPEC_BATCH_KEYS = ('img', 'pose', 'betas', 'pose_conf', 'pose_3d',
                   'keypoints_orig', 'has_smpl', 'has_pose_3d', 'orig_shape',
                   'scale', 'center', 'cam_rotmat', 'cam_intrinsics')
CAMCALIB_BATCH_KEYS = ('img', 'vfov', 'pitch', 'roll')
CAMCALIB_JITTER_KEYS = ('jitter_A', 'jitter_b', 'true_shape')


class TrainStep:
    """``step(state, batch, generator=None) -> (state, metrics)`` with
    ``batch`` a dict of tensors on the state's device holding the names
    ``keys(batch)`` gives (other entries are ignored). :meth:`eager`
    runs the body without graphs (for holding replays to it)."""

    def __init__(self, name: str, keys: Callable, loss_fn: Callable):
        self.keys = keys
        self.loss_fn = loss_fn
        self._state: Optional[TrainState] = None
        self.graphs = StageGraph(name, self._body)

    def _body(self, *tensors, update, generator, names):
        opt = self._state.optimizer
        for p in opt.params:
            p.grad = None
        # TF32 off for the whole step, the backward included (it runs
        # after the forward's precision contexts have closed): fp32 convs
        # and matmuls stay fp32; bf16 autocast regions are unaffected.
        with fp32_precision(), par.sharded_batch():
            total, metrics = self.loss_fn(self._state.model, generator,
                                          dict(zip(names, tensors)))
            total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in opt.params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if par.is_initialized():
            grads = par.all_reduce_gradients(grads)
            metrics = par.all_reduce_metrics(metrics)
        opt.step(grads, update)
        return metrics

    @property
    def mode(self) -> str:
        """How :meth:`__call__` runs the step: 'graph' (a CUDA graph
        replay on the card, the body directly on the CPU) or 'eager'
        (under gloo, whose collectives a graph cannot capture)."""
        return 'graph' if par.capturable() else 'eager'

    def _bind(self, state: TrainState) -> None:
        if self._state is not state:
            if self._state is not None and self.graphs.signatures():
                raise ValueError('a train step with captured graphs is '
                                 'bound to its first state')
            # every rank starts from rank 0's parameters and statistics
            par.broadcast_module(state.model)
            self._state = state

    def _run(self, state, batch, generator, body) -> tuple:
        self._bind(state)
        state.model.train()
        opt = state.optimizer
        update = opt.will_update()
        names = self.keys(batch)
        metrics = body(*[batch[k] for k in names], update=update,
                       generator=generator, names=names)
        if profiling.NAN_GUARD and body is not self.graphs:
            # (a StageGraph checks its own outputs)
            profiling.check_finite(f'train step {self.graphs.name!r}',
                                   metrics)
        opt.host_mini = 0 if update else opt.host_mini + 1
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None) -> tuple:
        return self._run(state, batch, generator,
                         self.graphs if self.mode == 'graph' else self._body)

    def eager(self, state: TrainState, batch: dict,
              generator: Optional[torch.Generator] = None) -> tuple:
        return self._run(state, batch, generator, self._body)


def make_spec_train_step(model, assets: S.SMPLAssets, tx=None,
                         loss_cfg: HMRLossConfig = HMRLossConfig()
                         ) -> TrainStep:
    """The SPEC training step on the model's device.

    Batch contract (tensors, leading dim B): img (B, 224, 224, 3 NHWC
    normalized), pose (B, 72 aa), betas (B, 10), pose_conf (B, 24),
    pose_3d (B, 24, 4), keypoints_orig (B, 49, 3), has_smpl (B,),
    has_pose_3d (B,), orig_shape (B, 2 as H, W), scale (B,), center
    (B, 2), cam_rotmat (B, 3, 3), cam_intrinsics (B, 3, 3). The GT
    camera is teacher-forced. Both SMPL forwards run the fused LBS
    kernel (its plain version on the CPU). ``tx`` is accepted for the JAX signature;
    the rule is the state's optimizer's."""
    del tx
    device = next(model.parameters()).device
    dev_assets = S.fused_on(assets, device)

    def loss_fn(model, generator, batch):
        with torch.no_grad():
            gt_verts = S.smpl_forward(
                dev_assets, betas=batch['betas'],
                body_pose=batch['pose'][:, 3:].reshape(-1, 23, 3),
                global_orient=batch['pose'][:, :3].reshape(-1, 1, 3),
                pose2rot=True, joint_set='native').vertices
        out = model(dev_assets, batch['img'], batch['cam_rotmat'],
                    batch['cam_intrinsics'], batch['scale'], batch['center'],
                    batch['orig_shape'][:, 1].float(),
                    batch['orig_shape'][:, 0].float(), generator=generator)
        return hmr_cam_loss(out, dict(batch, vertices=gt_verts), loss_cfg)

    return TrainStep('spec_train_step', lambda batch: SPEC_BATCH_KEYS,
                     loss_fn)


def make_camcalib_train_step(model, tx=None,
                             loss_type: str = 'softargmax_biased_l2',
                             vfov_loss_weight: float = 1.0,
                             pitch_loss_weight: float = 1.0,
                             roll_loss_weight: float = 1.0) -> TrainStep:
    """The CamCalib training step. Batch: img (B, H, W, 3), vfov, pitch,
    roll targets (bin indices for ce/kl, soft indices for the softargmax
    losses). With ``jitter_A`` in the batch (DATASET.DEVICE_JITTER) img
    is raw uint8 and ``jitter_A`` (B, 3, 3), ``jitter_b`` (B, 3) and the
    optional ``true_shape`` (B, 2) are applied on the device
    (``ops/preprocess.device_jitter_normalize``). Per-angle weights are
    MODEL.LOSS_{VFOV,PITCH,ROLL}_WEIGHT."""
    del tx

    def keys(batch):
        if 'jitter_A' not in batch:
            return CAMCALIB_BATCH_KEYS
        return CAMCALIB_BATCH_KEYS + tuple(
            k for k in CAMCALIB_JITTER_KEYS if k in batch)

    def loss_fn(model, generator, batch):
        img = batch['img']
        if 'jitter_A' in batch:
            img = device_jitter_normalize(img, batch['jitter_A'],
                                          batch['jitter_b'],
                                          batch.get('true_shape'))
        vfov, pitch, roll = model(img)
        return camera_regressor_loss(
            vfov, pitch, roll, batch['vfov'], batch['pitch'], batch['roll'],
            loss_type=loss_type, vfov_loss_weight=vfov_loss_weight,
            pitch_loss_weight=pitch_loss_weight,
            roll_loss_weight=roll_loss_weight)

    return TrainStep('camcalib_train_step', keys, loss_fn)
