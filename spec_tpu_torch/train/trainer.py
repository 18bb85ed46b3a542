"""SPEC training orchestration (torch twin of
``spec_tpu/train/trainer.py``).

epoch -> rebuild the train dataset (the staged-dataset and
teacher-force schedules live in ``make_train_dataset``) -> train steps
on the device (``train/steps.py``; one CUDA graph replay each on a card)
-> validation through ``eval/eval_loop.evaluate_dataset`` ->
checkpoints ranked by ``val_mpjpe`` (top-k) -> TensorBoard scalars,
when ``torch.utils.tensorboard`` imports, and every
``LOG_FREQ_TB_IMAGES`` steps a grid of meshes rendered over the batch's
first crops (:meth:`SpecTrainer._train_image_summary`).

NaN guard: the step's losses are read on the host every
``LOG_SAVE_INTERVAL`` steps and training stops on a non-finite loss.
SIGTERM saves the in-flight state with the number of batches already
consumed, so ``resume`` continues sample-exact mid-epoch.

TRAINING.RUN_SMPLIFY fits SMPL to each batch's keypoints before its
step (:meth:`SpecTrainer._run_smplify`, ``train/smplify.py``: one graph
replay for the prediction, one for the fit on a card) and swaps the fit
in as supervision where the acceptance rule takes it. TRAINING.REMAT is
the model's (``HMR(remat=True)``, which ``cli/spec_train`` builds from
it).

Multi-process (``parallel.initialize_multihost``, one process per GPU):
every rank runs the same steps on its slice of each global batch
(``DataLoader(process_id=...)``; the step reduces over the global batch,
``train/steps.py``), the ranks agree on a SIGTERM before the save
(``parallel.all_processes_any``), rank 0 alone writes checkpoints, meta
and TensorBoard, and each rank validates on its own.

TRAINING.FSDP shards the optimizer state leaf-wise over every rank
(full-axis FSDP) or, with TRAINING.FSDP_GROUP_SIZE = k > 1, over groups
of k consecutive ranks, replicated across the groups (HSDP), as the
reference's trainer lays its state out (``parallel/fsdp.py``: the
parameters stay whole on every rank). Ranks on several hosts need HSDP
with groups within a host. A checkpoint holds the whole state whatever
the layout: every rank enters the save (it gathers the slots) and rank 0
writes; a resume takes each rank's slice of the saved slots, so FSDP
and plain runs resume each other.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from spec_tpu_torch import parallel as par
from spec_tpu_torch.core import constants as C
from spec_tpu_torch.core import smpl as S
from spec_tpu_torch.losses import HMRLossConfig
from spec_tpu_torch.train.state import create_train_state, make_optimizer
from spec_tpu_torch.train.steps import SPEC_BATCH_KEYS, make_spec_train_step
from spec_tpu_torch.utils.checkpoints import (
    find_resume_checkpoint_dir,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from spec_tpu_torch.utils.graphs import StageGraph, device_constant
from spec_tpu_torch.utils.profiling import StepTimer, set_seed


class SpecTrainer:
    def __init__(self, cfg, model, assets_by_gender, j_regressor_h36m,
                 make_train_dataset, make_val_loaders):
        """cfg: a resolved CfgNode (``spec_default_config`` tree);
        model: the HMR module, on the device to train on, with its
        starting weights (the reference always starts from pretrained
        ones); make_train_dataset: fn(epoch) -> dataset; make_val_loaders:
        fn() -> {ds_name: loader}."""
        self.cfg = cfg
        self.model = model
        self.assets = assets_by_gender
        self.jreg = j_regressor_h36m
        self.make_train_dataset = make_train_dataset
        self.make_val_loaders = make_val_loaders
        self.device = next(model.parameters()).device

        training = cfg.TRAINING
        fsdp = bool(training.get('FSDP', False))
        fsdp_group = int(training.get('FSDP_GROUP_SIZE', 0) or 0)
        self.mesh = None
        if fsdp and fsdp_group > 1:
            # HSDP: the optimizer state shards over groups of k ranks and
            # replicates across them; the batch shards over every rank
            self.mesh = par.create_hybrid_mesh(fsdp=fsdp_group)
        elif fsdp:
            self.mesh = par.create_process_mesh()
        local = par.local_process_count()
        if par.spans_hosts() and fsdp and not (fsdp_group > 1
                                               and local % fsdp_group == 0):
            # a shard group across hosts would put every step's
            # reduce-scatter and all-gather on the network between them
            raise SystemExit(
                'multi-host + TRAINING.FSDP requires HSDP with '
                'within-host groups: set TRAINING.FSDP_GROUP_SIZE to a '
                f'divisor of the {local} local processes')
        world = par.process_count()
        if cfg.DATASET.BATCH_SIZE % world:
            raise SystemExit(
                f'DATASET.BATCH_SIZE={cfg.DATASET.BATCH_SIZE} must be '
                f'divisible by the {world} processes (each trains on its '
                'slice of every global batch)')
        if bool(training.get('REMAT', False)) != bool(
                getattr(model.backbone, 'remat', False)):
            raise ValueError(
                f'TRAINING.REMAT is {training.get("REMAT", False)} but the '
                f'model was built with remat={model.backbone.remat}: build '
                'it with HMR(remat=cfg.TRAINING.REMAT)')
        # Fail fast on an operator error the reference only catches at
        # validation time, after a whole trained epoch: in-the-wild val
        # sets have no 3D GT, so their evaluation needs images.
        from spec_tpu_torch.utils.config import split_ds_names
        itw = [n for n in split_ds_names(cfg.DATASET.VAL_DS)
               if n in ('mpii', 'coco')]
        if itw and not cfg.TESTING.SAVE_IMAGES:
            raise SystemExit(
                f'{itw} are in-the-wild datasets (no 3D GT): their '
                'evaluation is qualitative only — set '
                'TESTING.SAVE_IMAGES True (reference '
                'spec/trainer.py:262-269)')

        # The init buffers stay frozen (the reference's mean params).
        tx = make_optimizer(
            cfg.OPTIMIZER, freeze_buffers=True,
            grad_accum_steps=int(training.get('GRAD_ACCUM_STEPS', 1) or 1))
        loss_cfg = HMRLossConfig(
            shape_loss_weight=cfg.HMR.SHAPE_LOSS_WEIGHT,
            keypoint_loss_weight=cfg.HMR.KEYPOINT_LOSS_WEIGHT,
            pose_loss_weight=cfg.HMR.POSE_LOSS_WEIGHT,
            beta_loss_weight=cfg.HMR.BETA_LOSS_WEIGHT,
            openpose_train_weight=cfg.HMR.OPENPOSE_TRAIN_WEIGHT,
            gt_train_weight=cfg.HMR.GT_TRAIN_WEIGHT,
            loss_weight=cfg.HMR.LOSS_WEIGHT,
        )
        self.state = create_train_state(model, tx)
        if self.mesh is not None:
            par.shard_like(self.state, par.fsdp_shardings(
                self.state.optimizer.params, self.mesh))
        # SMPLify's SMPL (K1's operands attached) and its prediction graph
        self._fit_assets = None
        self._predict = None
        self.step = make_spec_train_step(model, assets_by_gender['neutral'],
                                         tx, loss_cfg)

        # only rank 0 writes checkpoints' meta, results and TensorBoard
        self.is_main = par.process_index() == 0
        self.writer = None
        if cfg.LOGDIR and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(
                    os.path.join(cfg.LOGDIR, 'tb_logs'),
                    max_queue=100_000, flush_secs=600)
        self.ckpt_dir = os.path.join(cfg.LOGDIR or '.', 'checkpoints')
        self.best: list = []  # [(val metric, step, checkpoints dir)]
        self._resume_epoch = 0
        self._resume_skip = 0

    # ------------------------------------------------------------------

    def resume(self, wo_optimizer: bool = False):
        """Restore the latest checkpoint. ``wo_optimizer`` takes the
        weights and BN statistics only and keeps the fresh optimizer and
        step 0 (the reference's ``--resume_wo_optimizer``).

        Each run has its own timestamped LOGDIR, so a crashed run's
        checkpoints are not in ``self.ckpt_dir``: fall back to
        TRAINING.RESUME, then to the latest sibling run with
        checkpoints."""
        ckpt_dir, step = self.ckpt_dir, None
        if latest_step(ckpt_dir) is None:
            found = find_resume_checkpoint_dir(
                self.cfg.LOGDIR,
                explicit=self.cfg.TRAINING.get('RESUME') or None)
            ckpt_dir, step = found if found else (None, None)
        if ckpt_dir is None:
            print('[train] WARNING: --resume requested but no checkpoint '
                  'found (no TRAINING.RESUME path and no prior run with '
                  'checkpoints next to this logdir) — starting from '
                  'scratch')
            return
        try:
            restored = load_checkpoint(ckpt_dir, step=step)
        except FileNotFoundError:
            print(f'[train] WARNING: no checkpoints in {ckpt_dir} — '
                  'starting from scratch')
            return
        print(f'[train] restoring from {ckpt_dir}'
              + (f' (pinned step {step})' if step is not None else ''))
        self.model.load_state_dict(restored['model'])
        if wo_optimizer:
            print('[train] resumed params/batch_stats only (fresh '
                  f'optimizer) from step {restored["step"]}')
            return
        self.state.optimizer.load_state_dict(restored['optimizer'])
        self.state.step = restored['step']
        print(f'[train] resumed from step {self.state.step}')
        try:
            with open(os.path.join(ckpt_dir, 'meta.json')) as f:
                meta = json.load(f)
            key = str(restored['step'])
            if key in meta.get('epochs', {}):
                self._resume_epoch = int(meta['epochs'][key])
            self._resume_skip = int(meta.get('skip', {}).get(key, 0))
            self.best = [(float(e[0]), int(e[1]),
                          e[2] if len(e) > 2 else ckpt_dir)
                         for e in meta.get('ranked', [])]
        except (OSError, ValueError, KeyError):
            pass

    def _read_meta(self) -> dict:
        try:
            with open(os.path.join(self.ckpt_dir, 'meta.json')) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_meta(self, next_epoch: int, step: int, skip: int = 0):
        """The sidecar, keyed by step: the epoch to run next after that
        step's checkpoint, the batches of it already consumed (``skip``,
        a mid-epoch preemption save) and the top-k ranking."""
        meta = self._read_meta()
        meta.setdefault('epochs', {})[str(int(step))] = int(next_epoch)
        meta.setdefault('skip', {})[str(int(step))] = int(skip)
        meta['ranked'] = [[float(v), int(st), d] for v, st, d in self.best]
        try:
            with open(os.path.join(self.ckpt_dir, 'meta.json'), 'w') as f:
                json.dump(meta, f)
        except OSError:
            pass

    def _device_batch(self, batch) -> dict:
        """The loader's numpy batch -> the step's tensors on the device,
        the crops ImageNet-normalized."""
        src = dict(batch, cam_intrinsics=batch['cam_int'])
        dev = {}
        for k in SPEC_BATCH_KEYS:
            v = torch.as_tensor(np.asarray(src[k], dtype=np.float32))
            dev[k] = v.to(self.device, non_blocking=True)
        mean = device_constant(C.IMG_NORM_MEAN, self.device)
        std = device_constant(C.IMG_NORM_STD, self.device)
        dev['img'] = (dev['img'] - mean) / std
        return dev

    def _fused_neutral(self):
        """The neutral SMPL on the device with K1's operands attached
        (SMPLify's and the image summary's model forward)."""
        if self._fit_assets is None:
            self._fit_assets = S.fused_on(self.assets['neutral'],
                                          self.device)
        return self._fit_assets

    def _train_image_summary(self, batch, global_step: int,
                             max_samples: int = 4):
        """A TensorBoard grid of the model's meshes on the batch's first
        ``max_samples`` crops: one row per sample, [crop | overlay | 90,
        180 and 270-degree side views] (``utils/renderer.render_tb_grid``
        on the host), written as ``train/mesh_grid``. The forward runs in
        eval mode without grad, through K1. The crop is the box-centred
        SPIN crop, so the full-image intrinsics are mapped through it
        (``crop_intrinsics``). A failure is printed and training goes
        on."""
        from spec_tpu_torch.utils.renderer import (
            crop_intrinsics,
            render_tb_grid,
        )

        try:
            n = min(max_samples, len(batch['img']))
            img = np.asarray(batch['img'][:n], np.float32)
            cols = {k: torch.as_tensor(np.asarray(batch[k][:n], np.float32),
                                       device=self.device)
                    for k in ('cam_rotmat', 'cam_int', 'scale', 'center',
                              'orig_shape')}
            mean = device_constant(C.IMG_NORM_MEAN, self.device)
            std = device_constant(C.IMG_NORM_STD, self.device)
            x = (torch.as_tensor(img, device=self.device) - mean) / std
            self.model.eval()
            try:
                with torch.no_grad():
                    out = self.model(
                        self._fused_neutral(), x, cols['cam_rotmat'],
                        cols['cam_int'], cols['scale'], cols['center'],
                        cols['orig_shape'][:, 1], cols['orig_shape'][:, 0])
                    verts = out['smpl_vertices'].float().cpu().numpy()
                    cam_t = out['pred_cam_t'].float().cpu().numpy()
            finally:
                self.model.train()
            focal, ctr = crop_intrinsics(batch['cam_int'][:n],
                                         batch['center'][:n],
                                         batch['scale'][:n], img.shape[1])
            grid = render_tb_grid(
                img, vertices=verts, camera_translation=cam_t,
                camera_rotation=np.asarray(batch['cam_rotmat'][:n]),
                focal_length=focal, camera_center=ctr,
                faces=self.assets['neutral'].faces.cpu().numpy(),
                max_samples=n)
            self.writer.add_image('train/mesh_grid', grid.transpose(2, 0, 1),
                                  global_step)
        except Exception as e:  # noqa: BLE001 -- printed, training goes on
            print(f'[train] image summary skipped: {type(e).__name__}: {e}')

    def _run_smplify(self, dev: dict) -> dict:
        """In-loop fitting (TRAINING.RUN_SMPLIFY): predict SMPL with the
        current model in eval mode (a StageGraph), fit it to the
        keypoints (``smplify_fit``, one graph replay) and, on the host,
        swap the fit in as supervision where its per-joint reprojection
        loss beats SMPLIFY_THRESHOLD (``apply_smplify_update``). Returns
        ``dev`` with new ``pose``, ``betas`` and ``has_smpl`` tensors."""
        from spec_tpu_torch.core.geometry import rotmat_to_aa
        from spec_tpu_torch.train.smplify import (
            apply_smplify_update,
            smplify_fit,
        )

        if self._predict is None:
            assets = self._fused_neutral()

            def predict(img, rotmat, K, scale, center, w, h):
                out = self.model(assets, img, rotmat, K, scale, center, w,
                                 h)
                return {k: out[k] for k in ('pred_pose', 'pred_shape',
                                            'pred_cam_t')}

            self._predict = StageGraph('smplify_predict', predict)
        self.model.eval()
        try:
            with torch.no_grad():
                out = self._predict(
                    dev['img'], dev['cam_rotmat'], dev['cam_intrinsics'],
                    dev['scale'], dev['center'], dev['orig_shape'][:, 1],
                    dev['orig_shape'][:, 0])
                aa = rotmat_to_aa(out['pred_pose'])         # (B, 24, 3)
        finally:
            self.model.train()
        res = smplify_fit(
            self._fit_assets, aa[:, :1], aa[:, 1:], out['pred_shape'],
            out['pred_cam_t'], dev['keypoints_orig'], dev['cam_rotmat'],
            dev['cam_intrinsics'],
            num_iters=int(self.cfg.TRAINING.NUM_SMPLIFY_ITERS))
        host = {k: dev[k] for k in ('pose', 'betas', 'has_smpl',
                                    'keypoints_orig')}
        upd = apply_smplify_update(
            host, res, float(self.cfg.TRAINING.SMPLIFY_THRESHOLD))
        out = dict(dev)
        for k in ('pose', 'betas', 'has_smpl'):
            out[k] = torch.as_tensor(upd[k], dtype=torch.float32).to(
                self.device, non_blocking=True)
        return out

    def _save(self, global_step: int):
        save_checkpoint(self.ckpt_dir, self.state, global_step, keep=1000)

    def fit(self, max_epochs: Optional[int] = None):
        from spec_tpu_torch.utils.preemption import GracefulShutdown

        with GracefulShutdown() as stop:
            return self._fit(max_epochs, stop)

    def _fit(self, max_epochs, stop):
        from spec_tpu_torch.data.loader import DataLoader

        cfg = self.cfg
        max_epochs = max_epochs or cfg.TRAINING.MAX_EPOCHS
        generator = set_seed(cfg.SEED_VALUE, self.device)
        if par.process_count() > 1:
            # each rank's rows draw their own dropout masks
            generator.manual_seed(max(int(cfg.SEED_VALUE), 0)
                                  + par.process_index())
            print(f'[train] rank {par.process_index()} of '
                  f'{par.process_count()} ({par.backend()}): the step runs '
                  + ('as one graph replay' if self.step.mode == 'graph'
                     else 'its eager body (gloo collectives cannot be '
                          'captured)'))
        layout = self.state.optimizer.layout
        if layout is not None:
            print(f'[train] FSDP over {self.mesh.shape}: {len(layout.sharded)}'
                  f' of {len(layout.params)} trainable tensors sharded, '
                  f'{self.state.optimizer.slot_bytes()} bytes of optimizer '
                  f'slots on rank {par.process_index()}')
        global_step = int(self.state.step)
        start_epoch = min(self._resume_epoch, max_epochs)
        if start_epoch:
            print(f'[train] resuming at epoch {start_epoch} '
                  f'(step {global_step})')
        resume_skip, self._resume_skip = self._resume_skip, 0

        for epoch in range(start_epoch, max_epochs):
            skip = resume_skip if epoch == start_epoch else 0
            batches_done = skip
            train_ds = self.make_train_dataset(epoch)
            group_keys = (train_ds.imgname
                          if cfg.DATASET.get('GROUP_BY_FRAME', False)
                          and hasattr(train_ds, 'imgname') else None)
            loader = DataLoader(
                train_ds, batch_size=cfg.DATASET.BATCH_SIZE,
                shuffle=cfg.DATASET.SHUFFLE_TRAIN,
                num_workers=cfg.DATASET.NUM_WORKERS, drop_last=True,
                seed=epoch, skip_batches=skip,
                process_id=par.process_index(),
                process_count=par.process_count(), group_keys=group_keys)
            if skip:
                print(f'[train] epoch {epoch}: skipping {skip} already-'
                      'trained batches (mid-epoch resume)')
            t0 = time.time()
            n_img = 0
            timer = StepTimer(prefix='train/')
            batch_iter = iter(loader)
            while True:
                with timer('load'):
                    batch = next(batch_iter, None)
                if batch is None:
                    break
                # the ranks agree before the save's barrier: their
                # SIGTERM latches may be an iteration apart
                if par.all_processes_any(stop.requested):
                    # Preemption: checkpoint the in-flight state (keep
                    # 1000: recency pruning must not delete the ranked
                    # best checkpoints) so --resume continues here.
                    self._save(global_step)
                    if self.writer:
                        self.writer.flush()
                    if self.is_main:
                        self._write_meta(epoch, global_step,
                                         skip=batches_done)
                        print(f'[train] preempted at step {global_step}; '
                              f'checkpoint saved to {self.ckpt_dir}')
                    return self.state
                with timer('h2d'):
                    dev = self._device_batch(batch)
                if cfg.TRAINING.RUN_SMPLIFY:
                    with timer('smplify'):
                        dev = self._run_smplify(dev)
                with timer('step'):
                    self.state, metrics = self.step(self.state, dev,
                                                    generator)
                global_step += 1
                batches_done += 1
                n_img += cfg.DATASET.BATCH_SIZE
                if global_step % cfg.TRAINING.LOG_SAVE_INTERVAL == 0:
                    values = {k: float(v) for k, v in metrics.items()}
                    total = values['loss/total_loss']
                    if not np.isfinite(total):
                        raise FloatingPointError(
                            f'non-finite loss at step {global_step}: '
                            f'{values}')
                    ips = n_img / (time.time() - t0)
                    print(f'[train] epoch {epoch} step {global_step} '
                          f'loss {total:.3f} ({ips:.1f} img/s | '
                          f'{timer.report()})')
                    if self.writer:
                        for k, v in values.items():
                            self.writer.add_scalar(f'train/{k}', v,
                                                   global_step)
                if (self.writer and cfg.LOG_FREQ_TB_IMAGES > 0
                        and global_step % cfg.LOG_FREQ_TB_IMAGES == 0):
                    self._train_image_summary(batch, global_step)

            val_every = max(int(cfg.TRAINING.CHECK_VAL_EVERY_N_EPOCH), 1)
            if (epoch + 1) % val_every == 0:
                val_metric = self.validate(epoch, global_step)
                self._save(global_step)
                if self.is_main:
                    self._write_meta(epoch + 1, global_step)
                    self._prune_ranked(val_metric, global_step)
            else:
                self._save(global_step)
                if self.is_main:
                    self._write_meta(epoch + 1, global_step)
            if self.writer:
                self.writer.flush()
        return self.state

    def _prune_ranked(self, val_metric: float, step: int, keep: int = 30):
        """Keep the ``keep`` best checkpoints by validation metric (the
        reference's ModelCheckpoint(save_top_k=30)); an entry carries
        the directory it was saved in (a resumed run prunes the previous
        run's). A NaN metric ranks nothing."""
        if not np.isfinite(val_metric):
            return
        self.best.append((float(val_metric), step, self.ckpt_dir))
        self.best.sort(key=lambda t: t[:2])
        for _, worst_step, worst_dir in self.best[keep:]:
            shutil.rmtree(os.path.join(worst_dir, f'step_{worst_step:08d}'),
                          ignore_errors=True)
        self.best = self.best[:keep]

    def validate(self, epoch: int, global_step: int) -> float:
        """``evaluate_dataset`` on each val loader with the model as it
        stands; returns the summed ``val_mpjpe`` (NaN when no dataset
        gave a finite one) and appends each summary to
        ``val_accuracy_results_<ds>.json``. Under several processes each
        rank evaluates on its own (no collectives), and only rank 0
        writes files."""
        from spec_tpu_torch.eval.eval_loop import evaluate_dataset

        total, n_finite = 0.0, 0
        try:
            for ds_name, loader in self.make_val_loaders().items():
                summary, _ = evaluate_dataset(
                    self.model, None, loader, self.assets, self.jreg,
                    use_gt_cam=self.cfg.TESTING.USE_GT_CAM,
                    use_gender=self.cfg.DATASET.USE_GENDER,
                    save_results=False,
                    logdir=(self.cfg.LOGDIR or None) if self.is_main
                    else None,
                    save_images=self.cfg.TESTING.SAVE_IMAGES,
                    save_freq=max(int(self.cfg.TESTING.SAVE_FREQ), 1),
                    dataset_name=ds_name)
                print(f'[val] epoch {epoch} {ds_name}: {summary}')
                if self.writer:
                    for k, v in summary.items():
                        if np.isfinite(v):
                            self.writer.add_scalar(f'val/{ds_name}/{k}', v,
                                                   global_step)
                v = summary.get('val_mpjpe', np.nan)
                if np.isfinite(v):
                    total += v
                    n_finite += 1
                else:
                    print(f'[val] WARNING: no finite val_mpjpe for '
                          f'{ds_name}; excluded from the ranking metric')
                self._append_results_json(ds_name, epoch, summary)
        finally:
            self.model.train()
        if n_finite == 0:
            print('[val] WARNING: no quantitative val metric produced; '
                  'skipping ranked checkpoint pruning this epoch')
            return float('nan')
        return total

    def _append_results_json(self, ds_name, epoch, summary):
        if not self.cfg.LOGDIR or not self.is_main:
            return
        path = os.path.join(self.cfg.LOGDIR,
                            f'val_accuracy_results_{ds_name}.json')
        hist = []
        if os.path.exists(path):
            with open(path) as f:
                hist = json.load(f)
        hist.append({'epoch': epoch, **summary})
        with open(path, 'w') as f:
            json.dump(hist, f, indent=2, default=float)


def parse_schedule(spec: str) -> dict:
    """``'0+a_b_0.5_0.5 5+c_1.0' -> {0: 'a_b_0.5_0.5', 5: 'c_1.0'}``
    (the reference's epoch-keyed schedule strings); a malformed entry
    raises."""
    if not spec:
        return {}
    out = {}
    for x in spec.split():
        epoch, plus, value = x.partition('+')
        if not plus or not epoch.isdigit() or not value:
            raise ValueError(
                f'malformed schedule entry {x!r} in {spec!r} — expected '
                "'<epoch>+<value>' tokens separated by spaces")
        out[int(epoch)] = value
    return out
