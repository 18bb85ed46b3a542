"""SPEC evaluation CLI (port of ``spec_tpu/cli/spec_eval.py``).

Two passes on the device:
  1. the in-loop pass (``eval/eval_loop.evaluate_dataset``): batched
     model forward + GT SMPL (gendered with DATASET.USE_GENDER) +
     J14/J24/V2V, dumped as ``evaluation_results_{ds}.pkl``;
  2. the offline headline pass (``eval/evaluator.compute_error``):
     W-MPJPE / MPJPE / PA-MPJPE / W-PVE / PVE from the dumped vertices and
     the predicted camera rotations.

Usage:
  python -m spec_tpu_torch.cli.spec_eval --cfg cfg.yaml \\
      --opts DATASET.VAL_DS 3dpw-test-cam TESTING.USE_GT_CAM False

Runs on the card (``--device cuda``, the default) and exits non-zero
without one unless ``--device cpu`` is given. Checkpoints are the
reference's torch files or the port trainer's checkpoint directories
(``spec_train``'s ``<logdir>/checkpoints``); a missing one gives a
seeded random init with a warning, and a JAX package (orbax) checkpoint
directory raises. ``TESTING.SAVE_IMAGES`` renders overlays to
``<logdir>/val_images/`` (and runs the in-the-wild sets' qualitative
pass). Not ported yet: ``--data_parallel`` and multi-host
``--coordinator_address`` (ROADMAP.md §1 item 12).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from spec_tpu_torch.cli._compat import add_cluster_flags
from spec_tpu_torch.cli._device import add_device_flag, resolve_device

PROG = 'spec_tpu_torch.cli.spec_eval'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='SPEC eval (PyTorch)')
    parser.add_argument('--cfg', type=str, default=None)
    parser.add_argument('--opts', nargs='*', default=[])
    parser.add_argument('--cfg_id', type=int, default=0)
    parser.add_argument('--ckpt', type=str, default='')
    parser.add_argument('--log_root', type=str, default='logs')
    parser.add_argument('--resume', action='store_true',
                        help='accepted for reference CLI parity (eval '
                             'loads --ckpt)')
    parser.add_argument('--resume_wo_optimizer', action='store_true',
                        help='accepted for reference CLI parity')
    parser.add_argument('--fdr', action='store_true',
                        help='fast dev run: one batch per dataset')
    parser.add_argument('--data_parallel', action='store_true',
                        help='not ported yet (ROADMAP.md §1 item 12)')
    parser.add_argument('--coordinator_address', type=str, default='',
                        help='multi-host eval: not ported yet (ROADMAP.md '
                             '§1 item 12)')
    parser.add_argument('--num_processes', type=int, default=None,
                        help='multi-host: total process count')
    parser.add_argument('--process_id', type=int, default=None,
                        help='multi-host: this process\'s rank')
    add_cluster_flags(parser)
    add_device_flag(parser)
    return parser


def load_assets_by_gender() -> dict:
    """SMPL assets from the registry dir (gendered where the files are
    there), or the synthetic neutral assets with a warning."""
    from spec_tpu_torch.core import smpl as S
    from spec_tpu_torch.utils import paths

    smpl_dir = paths.smpl_model_dir()
    assets = {}
    if os.path.isdir(smpl_dir) and os.listdir(smpl_dir):
        for g in ('neutral', 'male', 'female'):
            try:
                assets[g] = S.load_smpl_assets(
                    smpl_dir, gender=g,
                    j_regressor_extra_path=paths.j_regressor_extra_path(),
                    j_regressor_h36m_path=paths.j_regressor_h36m_path())
            except FileNotFoundError:
                pass
    if 'neutral' not in assets:
        print(f'[eval] WARNING: SMPL assets missing at {smpl_dir}; '
              'using synthetic test assets')
        assets = {'neutral': S.create_test_assets()}
    return assets


def h36m_regressor(assets) -> np.ndarray:
    """J_regressor_h36m (17, V) from the registry, else the assets'."""
    from spec_tpu_torch.utils import paths

    path = paths.j_regressor_h36m_path()
    if os.path.exists(path):
        return np.load(path)
    if assets.j_regressor_h36m is None:
        raise FileNotFoundError(f'J_regressor_h36m not found at {path}')
    return assets.j_regressor_h36m.numpy()


def build_model(cfg, ckpt: str, device):
    """The camera-aware HMR of the config on ``device``, in eval mode:
    ``ckpt``'s weights (a file in the reference's torch dialects, or the
    port trainer's checkpoint directory, ``<logdir>/checkpoints``, whose
    latest step loads) or, when it is missing, a random init from seed 0
    with a warning. A JAX package (orbax) checkpoint directory raises."""
    import torch

    from spec_tpu_torch.serving import build_hmr

    dtype = {'float32': torch.float32, 'bfloat16': torch.bfloat16}[
        cfg.HMR.get('DTYPE', 'float32')]
    return build_hmr(ckpt, device, backbone=cfg.HMR.BACKBONE,
                     use_cam_feats=cfg.HMR.USE_CAM_FEATS,
                     img_res=cfg.DATASET.IMG_RES, dtype=dtype, seed=0,
                     tag='eval')


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.data_parallel or args.coordinator_address:
        raise NotImplementedError(
            '--data_parallel and multi-host eval (--coordinator_address) '
            'are not ported yet (ROADMAP.md §1 item 12)')
    device = resolve_device(args.device, PROG)

    from spec_tpu_torch.data.cam_dataset import CamDataset
    from spec_tpu_torch.data.loader import DataLoader
    from spec_tpu_torch.eval.eval_loop import evaluate_dataset
    from spec_tpu_torch.eval.evaluator import compute_error
    from spec_tpu_torch.utils import paths
    from spec_tpu_torch.utils.config import (
        run_grid_search_experiments,
        spec_default_config,
        split_ds_names,
    )

    cfg = run_grid_search_experiments(
        args.cfg, spec_default_config(), script='spec_eval.py',
        cfg_id=args.cfg_id, opts=args.opts, log_root=args.log_root)
    cfg.RUN_TEST = True

    assets_by_gender = load_assets_by_gender()
    jreg = h36m_regressor(assets_by_gender['neutral'])
    model = build_model(cfg, args.ckpt or paths.spec_checkpoint_path(),
                        device)

    all_results = {}
    for ds_name in split_ds_names(cfg.DATASET.VAL_DS):
        annot = paths.dataset_files().get(ds_name)
        img_dir = paths.dataset_folders().get(ds_name)
        if not annot or not os.path.exists(annot):
            print(f'[eval] dataset {ds_name}: annotations not found '
                  f'({annot}); skipping')
            continue
        num_images = max(int(cfg.DATASET.get('NUM_IMAGES', -1)), 0)
        if args.fdr:
            num_images = int(cfg.DATASET.BATCH_SIZE)
        ds = CamDataset(annot, img_dir, dataset=ds_name, is_train=False,
                        img_res=cfg.DATASET.IMG_RES,
                        render_res=cfg.DATASET.RENDER_RES,
                        num_images=num_images,
                        emit_disp_img=cfg.TESTING.SAVE_IMAGES,
                        decode_cache=cfg.DATASET.get('DECODE_CACHE', 0),
                        native_decode=cfg.DATASET.get('NATIVE_DECODE',
                                                      True))
        if not cfg.TESTING.USE_GT_CAM and ds.camcalib_pitch is None:
            print(f'[eval] WARNING: {ds_name} has no camcalib_* columns '
                  'but TESTING.USE_GT_CAM=False — the predicted camera '
                  'falls back to identity/f=5000. Generate the columns '
                  'with: python -m spec_tpu_torch.cli.annotate_camcalib '
                  f'--npz {annot} --img_dir {img_dir}')
        loader = DataLoader(ds, batch_size=cfg.DATASET.BATCH_SIZE,
                            num_workers=cfg.DATASET.NUM_WORKERS)
        t0 = time.perf_counter()
        summary, acc = evaluate_dataset(
            model, None, loader, assets_by_gender, jreg,
            use_gt_cam=cfg.TESTING.USE_GT_CAM,
            use_gender=cfg.DATASET.USE_GENDER,
            save_results=cfg.TESTING.SAVE_RESULTS,
            save_images=cfg.TESTING.SAVE_IMAGES,
            save_freq=cfg.TESTING.SAVE_FREQ,
            logdir=cfg.LOGDIR, dataset_name=ds_name)
        dt = time.perf_counter() - t0
        print(f'[eval] {ds_name}: {summary} '
              f'({len(ds) / max(dt, 1e-6):.1f} img/s)')

        res = acc.results_dict()
        if cfg.TESTING.SAVE_RESULTS and len(res.get('vertices', [])):
            n = len(res['vertices'])
            headline = compute_error(
                ds_name,
                pred_vertices=np.asarray(res['vertices'], np.float32),
                pred_cam_rotmat=_pred_rotmats(ds)[:n],
                gt_pose=ds.pose, gt_betas=ds.betas,
                assets=assets_by_gender['neutral'],
                j_regressor_h36m=jreg,
                gt_pose_cam=_pose_cam(ds),
                gt_cam_rotmat=(np.asarray(ds.cam_rotmat, np.float32)
                               if ds.cam_rotmat is not None else None),
                device=device)
            print(f'[eval] {ds_name} headline: {headline}')
            summary.update({f'headline_{k}': v
                            for k, v in headline.items() if k != 'protocol'})
        all_results[ds_name] = summary
        _save_best_results(cfg.LOGDIR, ds_name, summary)

    print(json.dumps(all_results, indent=2, default=float))
    return all_results


def _pred_rotmats(ds) -> np.ndarray:
    """Per-sample predicted camera rotations from the camcalib columns
    (identity without them)."""
    from spec_tpu_torch.core.geometry import euler_pitch_roll_np

    n = len(ds)
    out = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    if ds.camcalib_pitch is not None and ds.camcalib_roll is not None:
        for i in range(n):
            out[i] = euler_pitch_roll_np(float(ds.camcalib_pitch[i]),
                                         float(ds.camcalib_roll[i]))
    return out


def _pose_cam(ds):
    """Camera-frame GT pose when the annotations carry one (3dpw, mtp)."""
    return ds.pose_cam


def _save_best_results(logdir, ds_name, summary):
    """Append the summary to ``val_accuracy_results_{ds}.json``."""
    path = os.path.join(logdir, f'val_accuracy_results_{ds_name}.json')
    history = []
    if os.path.exists(path):
        with open(path) as f:
            history = json.load(f)
    history.append(summary)
    with open(path, 'w') as f:
        json.dump(history, f, indent=2, default=float)


if __name__ == '__main__':
    main()
