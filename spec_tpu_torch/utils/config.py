"""Config yamls: a copy of ``spec_tpu/utils/config.py``.

:class:`CfgNode` is a copy of the reference's attribute-tree dict, and
:func:`spec_default_config` and :func:`camcalib_default_config` its SPEC
and CamCalib defaults, every tree whole (so every ``--opts`` key of a
train or eval command line exists).
:func:`run_grid_search_experiments` is the reference's grid search:
list-valued yaml leaves expand into the cartesian product of
configs, ``cfg_id`` picks one and its hyperparameters name the log
directory. PyYAML is imported where a file is read or written (the
machine with the card has none).
"""

from __future__ import annotations

import itertools
import operator
import os
import time
from functools import reduce
from typing import List, Optional, Union


class CfgNode(dict):
    """Nested attribute dict (yacs-lite)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def from_dict(cls, d: dict) -> 'CfgNode':
        node = cls()
        for k, v in d.items():
            node[k] = cls.from_dict(v) if isinstance(v, dict) else v
        return node

    def clone(self) -> 'CfgNode':
        return CfgNode.from_dict(self.to_dict())

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def merge_from_dict(self, other: dict):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str):
        import yaml

        with open(path) as f:
            self.merge_from_dict(yaml.safe_load(f) or {})

    def merge_from_list(self, opts: List[str]):
        """``['HMR.BACKBONE', 'resnet18', ...]`` override pairs; unknown
        keys are rejected, as yacs does."""
        if len(opts) % 2:
            raise ValueError(f'odd --opts list: {opts}')
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(
                    f'--opts key {key!r} does not exist in the config '
                    f'(yacs rejects unknown keys; check for typos)')
            node[parts[-1]] = _coerce(val, node[parts[-1]])

    def dump(self, path: str):
        import yaml

        with open(path, 'w') as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False)


def _coerce(val: str, old):
    import yaml

    if isinstance(old, bool):
        return val in ('True', 'true', '1')
    if isinstance(old, int):
        try:
            return int(val)
        except ValueError:
            return float(val)
    if isinstance(old, float):
        return float(val)
    try:
        return yaml.safe_load(val)
    except yaml.YAMLError:
        return val


def spec_default_config() -> CfgNode:
    """The reference's SPEC defaults (``spec_tpu.utils.config``)."""
    return CfgNode.from_dict({
        'EXP_NAME': 'spec',
        'LOGDIR': '',
        'LOG_DIR': 'logs/experiments',
        'LOG_FREQ_TB_IMAGES': 500,
        'SEED_VALUE': -1,
        'METHOD': 'hmr_cam',
        'PROJECT_NAME': 'spec',
        'SYSTEM': {'GPU': '', 'CLUSTER_NODE': 0.0},
        'DATASET': {
            'LOAD_TYPE': 'Base',
            'NOISE_FACTOR': 0.4,
            'ROT_FACTOR': 0.0,
            'SCALE_FACTOR': 0.25,
            'FLIP_PROB': 0.0,
            'CROP_PROB': 0.0,
            'CROP_FACTOR': 0.0,
            'BATCH_SIZE': 64,
            'NUM_WORKERS': 8,
            'FAST_DECODE': False,
            'DECODE_CACHE': 0,
            'GROUP_BY_FRAME': False,
            'NATIVE_DECODE': True,
            'REGION_CACHE_DIR': '',
            'REGION_CACHE_FORMAT': 'jpeg',
            'PIN_MEMORY': True,
            'SHUFFLE_TRAIN': True,
            'TRAIN_DS': 'all',
            'VAL_DS': 'spec-syn_spec-mtp_3dpw-test-cam',
            'NUM_IMAGES': -1,
            'TRAIN_NUM_IMAGES': -1,
            'TEST_NUM_IMAGES': -1,
            'IGNORE_3D': False,
            'IMG_RES': 224,
            'RENDER_RES': 480,
            'FOCAL_LENGTH': 5000.0,
            'MESH_COLOR': 'pinkish',
            'DATASETS_AND_RATIOS': 'spec-syn_1.0',
            'USE_SYNTHETIC_OCCLUSION': False,
            'OCC_AUG_DATASET': 'pascal',
            'USE_3D_CONF': False,
            'USE_GENDER': False,
            'BASELINE_CAM_ROT': False,
            'BASELINE_CAM_F': False,
            'BASELINE_CAM_C': False,
            'TEACHER_FORCE': 0.0,
            'TEACHER_FORCE_SCHEDULE': '',
            'STAGE_DATASETS': '',
            'NONPARAMETRIC': False,
        },
        # TYPE/LR/WD are the reference's; the rest are off by default
        # (train/state.make_optimizer).
        'OPTIMIZER': {'TYPE': 'adam', 'LR': 1e-4, 'WD': 0.0,
                      'SCHEDULE': '', 'WARMUP_STEPS': 0,
                      'DECAY_STEPS': 0, 'DECAY_RATE': 0.1,
                      'MIN_LR_RATIO': 0.0, 'CLIP_GRAD_NORM': 0.0,
                      'MOMENTUM': 0.9},
        'TRAINING': {
            'RESUME': None,
            'PRETRAINED': None,
            'PRETRAINED_LIT': None,
            'MAX_EPOCHS': 100,
            'LOG_SAVE_INTERVAL': 50,
            'LOG_FREQ_TB_IMAGES': 500,
            'CHECK_VAL_EVERY_N_EPOCH': 1,
            'RELOAD_DATALOADERS_EVERY_EPOCH': True,
            'NUM_SMPLIFY_ITERS': 100,
            'RUN_SMPLIFY': False,
            'SMPLIFY_THRESHOLD': 100,
            'DROPOUT_P': 0.2,
            'TEST_BEFORE_TRAINING': False,
            'SAVE_IMAGES': False,
            'USE_PART_SEGM_LOSS': False,
            'USE_AMP': False,
            'FSDP': False,
            'FSDP_GROUP_SIZE': 0,
            'GRAD_ACCUM_STEPS': 1,
            'REMAT': False,
        },
        'TESTING': {
            'SAVE_IMAGES': False,
            'SAVE_FREQ': 1,
            'SAVE_RESULTS': True,
            'SAVE_MESHES': False,
            'SIDEVIEW': True,
            'TEST_ON_TRAIN_END': True,
            'MULTI_SIDEVIEW': False,
            'USE_GT_CAM': False,
        },
        'HMR': {
            'BACKBONE': 'resnet50',
            # hmr (SPIN's regressor) or transformer_decoder (HMR 2.0's,
            # with BACKBONE vit_h)
            'HEAD': 'hmr',
            'DTYPE': 'float32',
            'USE_CAM_FEATS': False,
            'SHAPE_LOSS_WEIGHT': 0.0,
            'KEYPOINT_LOSS_WEIGHT': 5.0,
            'KEYPOINT_NATIVE_LOSS_WEIGHT': 5.0,
            'SMPL_PART_LOSS_WEIGHT': 1.0,
            'POSE_LOSS_WEIGHT': 1.0,
            'BETA_LOSS_WEIGHT': 0.001,
            'OPENPOSE_TRAIN_WEIGHT': 0.0,
            'GT_TRAIN_WEIGHT': 1.0,
            'LOSS_WEIGHT': 60.0,
            'ESTIMATE_UNCERTAINTY': False,
            'UNCERTAINTY_ACTIVATION': '',
            'USE_SEPARATE_VAR_BRANCH': False,
            'UNCERTAINTY_LOSS': 'MultivariateGaussianNegativeLogLikelihood',
        },
        'RUN_TEST': False,
    })


def camcalib_default_config() -> CfgNode:
    """The reference's CamCalib defaults (``spec_tpu.utils.config``)."""
    return CfgNode.from_dict({
        'EXP_NAME': 'camcalib',
        'LOGDIR': '',
        'LOG_DIR': 'logs/camcalib',
        'METHOD': 'camcalib',
        'PROJECT_NAME': 'camcalib',
        'SEED_VALUE': -1,
        'SYSTEM': {'GPU': '', 'CLUSTER_NODE': 0.0},
        'DATASET': {
            'TRAIN_DS': 'pano',
            'VAL_DS': 'pano',
            'MIN_RES': 600,
            'MAX_RES': 1000,
            'BATCH_SIZE': 32,
            'NUM_WORKERS': 8,
            'PIN_MEMORY': True,
            'SHUFFLE_TRAIN': True,
            'IMG_RES': 224,
            # PIL draft decode of the train loader's JPEGs (the samples
            # resize down to MIN_RES anyway).
            'FAST_DECODE': False,
            # Decoded and resized frames kept per dataset (0: none).
            'DECODE_CACHE': 0,
            # Subsample the split without replacement (-1: all).
            'NUM_IMAGES': -1,
            # ColorJitter and normalize on the device for the train
            # loader: items carry raw uint8 and a per-image affine.
            'DEVICE_JITTER': False,
            # Legacy alias of MODEL.LOSS_TYPE (resolve_camcalib_loss).
            'LOSS_TYPE': 'ce',
        },
        'OPTIMIZER': {'TYPE': 'adam', 'LR': 1e-3, 'WD': 0.0,
                      'SCHEDULE': '', 'WARMUP_STEPS': 0,
                      'DECAY_STEPS': 0, 'DECAY_RATE': 0.1,
                      'MIN_LR_RATIO': 0.0, 'CLIP_GRAD_NORM': 0.0,
                      'MOMENTUM': 0.9},
        'TRAINING': {
            'RESUME': None,
            'PRETRAINED': None,
            'PRETRAINED_LIT': None,
            'MAX_EPOCHS': 100,
            'LOG_SAVE_INTERVAL': 50,
            'LOG_FREQ_TB_IMAGES': 500,
            'CHECK_VAL_EVERY_N_EPOCH': 1,
            'RELOAD_DATALOADERS_EVERY_EPOCH': True,
            'SAVE_IMAGES': False,
            'GRAD_ACCUM_STEPS': 1,
        },
        'MODEL': {
            'BACKBONE': 'resnet34',
            'DTYPE': 'float32',
            'NUM_FC_LAYERS': 1,
            'NUM_FC_CHANNELS': 1024,
            'LOSS_VFOV_WEIGHT': 1.0,
            'LOSS_PITCH_WEIGHT': 1.0,
            'LOSS_ROLL_WEIGHT': 1.0,
            'LOSS_TYPE': 'ce',
        },
        'RUN_TEST': False,
    })


def resolve_camcalib_loss(cfg: CfgNode) -> str:
    """The CamCalib loss type from either config dialect: MODEL.LOSS_TYPE
    (the reference's) or the legacy DATASET.LOSS_TYPE; a value other
    than the default 'ce' wins, MODEL's when both are set."""
    model_lt = cfg.get('MODEL', {}).get('LOSS_TYPE', 'ce')
    dataset_lt = cfg.get('DATASET', {}).get('LOSS_TYPE', 'ce')
    return model_lt if model_lt != 'ce' else dataset_lt


def update_hparams(cfg_file: Optional[str] = None,
                   dialect: str = 'spec') -> CfgNode:
    """The defaults merged with a yaml (the reference's config entry
    point); ``dialect`` 'spec' or 'camcalib' picks the default tree."""
    cfg = (camcalib_default_config() if dialect == 'camcalib'
           else spec_default_config())
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    return cfg


def split_ds_names(value: Union[str, list]) -> List[str]:
    """``'a_b'`` or ``['a_b', 'c']`` -> ``['a', 'b', 'c']`` (dataset
    names never hold '_', the reference's separator)."""
    items = value if isinstance(value, list) else [value]
    return [n for it in items for n in str(it).split('_') if n]


def _flatten(d: dict, prefix: str = '') -> dict:
    out = {}
    for k, v in d.items():
        key = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(d: dict) -> dict:
    out: dict = {}
    for k, v in d.items():
        node = out
        parts = k.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def get_grid_search_configs(config: dict, excluded_keys: List[str] = ()):
    """List-valued leaves -> the cartesian product of configs, as
    (experiments, hyperparameter keys). An excluded list-valued leaf
    stays one value (joined with '+' and split back); booleans pass
    through strings, as in the reference."""
    flat = _flatten(config)
    hyper_params = []
    joined_excluded = set()
    for k, v in flat.items():
        if isinstance(v, list):
            if k in excluded_keys:
                flat[k] = ['+'.join(str(x) for x in v)]
                joined_excluded.add(k)
            elif len(v) > 1:
                hyper_params.append(k)
            if v and isinstance(v[0], bool):
                flat[k] = [str(x) for x in v]
        elif isinstance(v, bool):
            flat[k] = [str(v)]
        else:
            flat[k] = [v]

    keys, values = zip(*flat.items()) if flat else ((), ())
    experiments = [dict(zip(keys, combo))
                   for combo in itertools.product(*values)]
    for exp in experiments:
        for param in joined_excluded:
            if param in exp:
                exp[param] = str(exp[param]).strip().split('+')
        for k, v in exp.items():
            if v == 'True':
                exp[k] = True
            elif v == 'False':
                exp[k] = False
    return [_unflatten(e) for e in experiments], hyper_params


def run_grid_search_experiments(
    cfg_file: Optional[str],
    default_config: CfgNode,
    script: str = 'train.py',
    cfg_id: int = 0,
    opts: Optional[List[str]] = None,
    log_root: str = 'logs',
) -> CfgNode:
    """Pick experiment ``cfg_id`` of the grid, make its log directory
    ``{log_root}/{script}/{EXP_NAME}/{timestamp}_{hyperparameters}`` and
    write the resolved config there as ``config_to_run.yaml``."""
    cfg = default_config.clone()
    if cfg_file:
        cfg.merge_from_file(cfg_file)
    if opts:
        cfg.merge_from_list(list(opts))

    experiments, hyper_params = get_grid_search_configs(
        cfg.to_dict(),
        excluded_keys=['DATASET/DATASETS_AND_RATIOS', 'DATASET/VAL_DS'])
    if not 0 <= cfg_id < len(experiments):
        raise ValueError(f'cfg_id {cfg_id} out of range '
                         f'({len(experiments)} experiments)')
    exp = experiments[cfg_id]
    resolved = default_config.clone()
    resolved.merge_from_dict(exp)

    def get_from(d, key):
        return reduce(operator.getitem, key.split('/'), d)

    suffix = '_'.join(
        f"{k.split('/')[-1]}-{get_from(exp, k)}" for k in hyper_params)
    exp_name = getattr(resolved, 'EXP_NAME', 'spec')
    timestamp = time.strftime('%d-%m-%Y_%H-%M-%S')
    logdir = os.path.join(
        log_root, script.replace('.py', ''), exp_name,
        f'{timestamp}_{suffix}' if suffix else timestamp)
    os.makedirs(logdir, exist_ok=True)
    resolved['LOGDIR'] = logdir
    resolved['CFG_ID'] = cfg_id
    resolved['NUM_EXPERIMENTS'] = len(experiments)
    resolved.dump(os.path.join(logdir, 'config_to_run.yaml'))
    return resolved


def hmr_hparams_from_cfg(cfg_file: str) -> tuple:
    """(backbone, use_cam_feats, head) from a SPEC config yaml: the model
    hyperparameters shipped next to a checkpoint."""
    cfg = spec_default_config()
    cfg.merge_from_file(cfg_file)
    return cfg.HMR.BACKBONE, bool(cfg.HMR.USE_CAM_FEATS), cfg.HMR.HEAD
