"""CamCalib inference CLI (port of ``spec_tpu/cli/camcalib_demo.py``).

Per image a pickle with ``{vfov, f_pix, pitch, roll}`` and a horizon-line
overlay PNG, as the reference's ``scripts/camcalib_demo.py`` writes them.
Images are read and resized on the host with PIL (the reference's
pixels), grouped by resized shape, and each group runs in padded batches
through one stage function on the device: normalize, CamCalib, bin
decode. On a GPU the function replays a CUDA graph per batch shape
(``utils/graphs.StageGraph``).

Usage:
  python -m spec_tpu_torch.cli.camcalib_demo --img_folder in/ \\
      --out_folder out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from spec_tpu_torch.cli._device import add_device_flag, resolve_device
from spec_tpu_torch.data.image_folder import ImageFolder, list_images
from spec_tpu_torch.serving import _cam_forward, build_camcalib
from spec_tpu_torch.utils import paths
from spec_tpu_torch.utils.graphs import StageGraph

# Process-level cache: the chunked video demo runs the folder pipeline
# once per chunk; checkpoints load and graphs are captured once.
_MODEL_CACHE: dict = {}


def _get_model(ckpt: str, backbone: str, loss_type: str,
               device='cuda'):
    """-> (CameraRegressorNetwork on ``device``, its stage graph: the
    predictor's stage-1 body, ``serving._cam_forward``)."""
    device = torch.device(device)
    key = (ckpt, backbone, loss_type, str(device))
    if key not in _MODEL_CACHE:
        model = build_camcalib(ckpt, backbone, device, seed=0,
                               tag='camcalib')
        stage = StageGraph('camcalib_demo', functools.partial(
            _cam_forward, model, loss_type))
        _MODEL_CACHE[key] = (model, stage)
    return _MODEL_CACHE[key]


def run_camcalib_on_folder(
    img_folder: str,
    out_folder: str,
    ckpt: str = '',
    loss_type: str = 'softargmax_l2',
    backbone: str = 'resnet50',
    batch_size: int = 16,
    save_images: bool = True,
    min_size: int = 600,
    show_distributions: bool = False,
    image_list: list | None = None,
    gt_angles: dict | None = None,
    device='cuda',
):
    """Returns {imgname: {vfov, f_pix, pitch, roll}} and writes a pickle
    per image (the stage-1 -> stage-2 interface of the demos).

    ``image_list`` overrides the folder listing (``--dataset`` mode).
    ``gt_angles`` maps imgname -> (vfov, pitch, roll) in radians; then
    the pickles also carry the GT fields and a second (GT) horizon is
    drawn."""
    import joblib

    ckpt = ckpt or paths.camcalib_checkpoint_path()
    if image_list is None:
        image_list = list_images(img_folder)
    dataset = ImageFolder(image_list, min_size=min_size)

    # Output names: the path relative to the input root with separators
    # flattened, so nested dataset imgnames cannot collide; for a flat
    # --img_folder this is the basename.
    if img_folder is not None:
        name_root = img_folder
    elif len(image_list) > 1:
        name_root = os.path.commonpath([os.path.dirname(p)
                                        for p in image_list])
    else:
        name_root = os.path.dirname(image_list[0]) if image_list else '.'

    def out_name(imgname: str) -> str:
        return os.path.relpath(imgname, name_root).replace(os.sep, '_')
    os.makedirs(out_folder, exist_ok=True)

    model, stage = _get_model(ckpt, backbone, loss_type, device)
    dev = next(model.parameters()).device

    results = {}
    t0 = time.perf_counter()
    n = 0
    for idxs in dataset.shape_buckets().values():
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            items = [dataset.load_u8(i) for i in chunk]
            # Pad the tail batch: one batch shape per bucket.
            padded = items + [items[-1]] * (batch_size - len(items))
            batch = torch.from_numpy(np.stack([it[0] for it in padded]))
            with torch.inference_mode():
                *logits, angles = stage(batch.to(dev))
            vfov, pitch, roll = angles.cpu().numpy()
            for k, i in enumerate(chunk):
                imgname = dataset.image_filenames[i]
                orig_h = items[k][1][1]
                res = {
                    'vfov': np.float32(vfov[k]),
                    'f_pix': np.float32(orig_h / 2.0 / np.tan(vfov[k] / 2.0)),
                    'pitch': np.float32(pitch[k]),
                    'roll': np.float32(roll[k]),
                }
                base = out_name(imgname)
                gt = (gt_angles or {}).get(imgname)
                if gt is not None:
                    gt_vfov, gt_pitch, gt_roll = (float(x) for x in gt)
                    res.update({
                        'gt_vfov': np.float32(gt_vfov),
                        'gt_f_pix': np.float32(
                            orig_h / 2.0 / np.tan(gt_vfov / 2.0)),
                        'gt_pitch': np.float32(gt_pitch),
                        'gt_roll': np.float32(gt_roll),
                    })
                joblib.dump(res, os.path.join(out_folder, base + '.pkl'))
                results[imgname] = res
                n += 1
                if save_images:
                    _save_horizon(imgname, os.path.join(out_folder, base),
                                  gt, (vfov[k], pitch[k], roll[k]))
                if show_distributions:
                    _plot_distributions(
                        [lg[k].cpu().numpy() for lg in logits],
                        os.path.join(out_folder, base + '_dist.png'))
    dt = time.perf_counter() - t0
    print(f'[camcalib] {n} images in {dt:.2f}s ({n / max(dt, 1e-6):.1f} '
          'img/s incl. IO)')
    return results


def _save_horizon(imgname, out_path, gt, pred):
    """The predicted horizon (and the GT one, when given) over the
    original image."""
    from PIL import Image

    from spec_tpu_torch.utils.vis import draw_horizon_line, gt_vs_pred_horizon

    with Image.open(imgname) as im:
        img = np.asarray(im.convert('RGB'))
    vis = (gt_vs_pred_horizon(img, gt, pred) if gt is not None
           else draw_horizon_line(img, *pred))
    Image.fromarray(vis).save(out_path)


def _plot_distributions(logit_rows, out_path):
    """Bar plots of the 256-bin distribution per angle (the reference's
    --show option)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3))
    for ax, logits, name in zip(axes, logit_rows,
                                ('vfov', 'pitch', 'roll')):
        p = np.exp(logits - logits.max())
        ax.bar(np.arange(len(p)), p / p.sum(), width=1.0)
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)


def _dataset_image_list(name: str) -> list:
    """Unique full-image paths of a registered SPEC dataset (the
    ``--dataset`` mode)."""
    annot = paths.dataset_files()[name]
    folder = paths.dataset_folders()[name]
    imgs = np.load(annot, allow_pickle=True)['imgname']
    return sorted({os.path.join(folder, str(x)) for x in imgs})


def _pano_annot_path(imgname: str, dataset: str) -> str:
    """A pano image's GT json (``CameraRegressorDataset._annot_path``)."""
    if dataset == 'pano':
        return imgname.replace('images', 'annotations').replace(
            '.png', '.json').replace('.jpg', '.json')
    return imgname.rsplit('.', 1)[0] + '.json'


def _pano_val_inputs(dataset: str = 'pano_scalenet'):
    """Image list and GT angles of the pano val split (the reference's
    dataset-less evaluation mode): the split's file list and each image's
    GT json, as ``CameraRegressorDataset`` reads them."""
    import json

    import joblib

    folder = paths.dataset_folders().get('pano360', 'data/pano360')
    image_list, gt = [], {}
    for nm in joblib.load(os.path.join(folder, 'val_images.pkl')):
        imgname = os.path.join(folder, 'images', nm)
        with open(_pano_annot_path(imgname, dataset)) as f:
            data = json.load(f)
        vfov = (np.radians(float(data['vfov'])) if dataset == 'pano'
                else float(data['vfov']))
        image_list.append(imgname)
        gt[imgname] = (vfov, float(data['pitch']), float(data['roll']))
    return image_list, gt


def main(argv=None):
    parser = argparse.ArgumentParser(description='CamCalib demo (PyTorch)')
    parser.add_argument('--img_folder', type=str, default=None,
                        help="input folder; '-' with no --dataset runs "
                             'the pano val split with GT comparison')
    parser.add_argument('--out_folder', type=str, required=True)
    parser.add_argument('--dataset', type=str, default=None,
                        help='registered SPEC dataset name to run on')
    parser.add_argument('--loss', type=str, default='softargmax_l2')
    parser.add_argument('--ckpt', type=str, default='')
    parser.add_argument('--backbone', type=str, default='resnet50')
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--min_size', type=int, default=600,
                        help='aspect-preserving resize target (reference '
                             'Resize(600))')
    parser.add_argument('--no_save', action='store_true',
                        help='do not save horizon-line images')
    parser.add_argument('--show', action='store_true',
                        help='save raw bin-distribution bar plots')
    add_device_flag(parser)
    args = parser.parse_args(argv)

    if args.img_folder is None and args.dataset is None:
        parser.error("give --img_folder DIR, --dataset NAME, or "
                     "--img_folder - (pano val split with GT comparison)")
    device = resolve_device(args.device, 'spec_tpu_torch.cli.camcalib_demo')
    img_folder = None if args.img_folder == '-' else args.img_folder
    image_list, gt_angles = None, None
    if img_folder is None:
        if args.dataset is not None:
            image_list = _dataset_image_list(args.dataset)
        else:
            image_list, gt_angles = _pano_val_inputs()

    run_camcalib_on_folder(
        img_folder, args.out_folder, ckpt=args.ckpt,
        loss_type=args.loss, backbone=args.backbone,
        batch_size=args.batch_size, save_images=not args.no_save,
        min_size=args.min_size, show_distributions=args.show,
        image_list=image_list, gt_angles=gt_angles, device=device)


if __name__ == '__main__':
    main()
