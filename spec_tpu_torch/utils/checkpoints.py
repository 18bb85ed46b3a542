"""Checkpoint IO for the port.

* :func:`load_torch_state_dict`: the three reference torch dialects
  (lightning ``.ckpt``, plain state_dict, legacy SPIN ``['model']``) ->
  one flat {name: np.ndarray}; a copy of the JAX package's reader.
* :func:`select_state_dict` / :func:`hmr_state_dict`: that flat dict ->
  the state_dict of this package's modules (same names as the reference,
  so this is mostly selecting keys; for HMR, SPIN's unprefixed head keys
  and missing init buffers are handled as the JAX converter handles them).
* :func:`merge_with_template` / :func:`load_camcalib_variables`: a
  released CamCalib file as a state_dict, keeping a fresh model's
  tensor wherever the file's shape differs or is missing (the
  reference's ``overwrite_shape_mismatch=True``).
* :func:`state_dict_from_flax`: the weight bridge from the JAX package's
  flax variables to this package's state_dicts (inverse of
  ``convert_torch_{resnet,hrnet,camcalib,hmr}_params``; and the YOLOv3
  detector's).
* :func:`assets_from_jax`: the same bridge for ``SMPLAssets``.
* :func:`save_checkpoint`, :func:`restore_checkpoint`,
  :func:`latest_step`, :func:`find_resume_checkpoint_dir`: the
  trainer's own checkpoints, in the JAX package's directory layout.
"""

from __future__ import annotations

import json
import os
import shutil
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

_HEAD_KEYS = ('fc1.', 'fc2.', 'decpose.', 'decshape.', 'deccam.', 'drop1.',
              'drop2.', 'init_pose', 'init_shape', 'init_cam',
              'decpose_var.', 'decshape_var.')


def load_torch_state_dict(path: str) -> dict:
    """Load any of the three torch dialects -> flat {name: np.ndarray},
    with lightning ``model.`` prefixes stripped."""
    blob = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(blob, dict) and 'state_dict' in blob:
        sd = blob['state_dict']          # lightning
    elif isinstance(blob, dict) and 'model' in blob and not any(
            hasattr(v, 'numpy') for v in list(blob.values())[:3]
            if not isinstance(v, dict)):
        sd = blob['model']               # legacy SPIN
    else:
        sd = blob                        # plain state_dict
    out = {}
    for k, v in sd.items():
        if k.startswith('model.'):
            k = k[len('model.'):]
        try:
            out[k] = v.detach().cpu().numpy()
        except AttributeError:
            out[k] = np.asarray(v)
    return out


def select_state_dict(sd: dict, model: torch.nn.Module,
                      keep_init: tuple = ()) -> dict:
    """Flat reference dict -> ``model``'s state_dict: keep the model's own
    keys (extra checkpoint keys are ignored, as the JAX converters ignore
    them); BN ``num_batches_tracked`` counters may be absent, and so may
    keys that start with one of ``keep_init`` (the model's own tensor is
    kept). Any other missing key raises."""
    out = {}
    missing = []
    for k, ref in model.state_dict().items():
        if k in sd:
            out[k] = torch.as_tensor(np.asarray(sd[k]), dtype=ref.dtype)
        elif k.endswith('num_batches_tracked'):
            out[k] = torch.zeros_like(ref)
        elif k.startswith(keep_init):
            out[k] = ref.detach().clone()
        else:
            missing.append(k)
    if missing:
        raise KeyError(f'checkpoint lacks {len(missing)} parameter(s) of '
                       f'{type(model).__name__}, e.g. {missing[:3]}')
    return out


def hmr_state_dict(sd: dict, model: torch.nn.Module,
                   mean_params: dict = None) -> dict:
    """Flat reference SPEC/HMR dict (lightning, PARE or SPIN dialect) ->
    ``model``'s state_dict. Checkpoints without the init buffers get
    them from ``mean_params`` (default: identity mean params). An HRNet
    trunk's ``-conv`` downsample head (PARE's, not in the official
    trunk) keeps the model's init where the file lacks it, as the JAX
    converter does."""
    from spec_tpu_torch.models.heads.hmr_head import default_init_params

    if not any(k.startswith(('backbone.', 'head.')) for k in sd):
        sd = {(('head.' if k.startswith(_HEAD_KEYS) else 'backbone.') + k): v
              for k, v in sd.items()}
    fallback = mean_params or default_init_params()
    sd = dict(sd)
    for buf in ('init_pose', 'init_shape', 'init_cam'):
        sd.setdefault(f'head.{buf}', fallback[buf])
    return select_state_dict(sd, model,
                             keep_init=('backbone.downsample_stage_',))


def merge_with_template(state_dict: dict, template: dict,
                        verbose: bool = True) -> 'OrderedDict':
    """``template``'s keys (a freshly initialized model's state_dict),
    each taken from ``state_dict`` where it is there with the same
    shape, else kept from ``template`` (printed when ``verbose``)."""
    out = OrderedDict()
    for k, leaf in template.items():
        cand = state_dict.get(k)
        if cand is not None and tuple(np.shape(cand)) == tuple(leaf.shape):
            out[k] = torch.as_tensor(np.asarray(cand), dtype=leaf.dtype)
            continue
        if verbose and cand is not None:
            print(f'[checkpoints] shape mismatch at {k}: checkpoint '
                  f'{tuple(np.shape(cand))} vs model {tuple(leaf.shape)} '
                  '— keeping model init')
        elif verbose and not k.endswith('num_batches_tracked'):
            print(f'[checkpoints] missing in checkpoint: {k} — keeping '
                  'model init')
        out[k] = leaf.detach().clone()
    return out


def load_camcalib_variables(path: str, backbone: str = 'resnet50',
                            num_fc_layers: int = 1,
                            template: Optional[dict] = None) -> dict:
    """A released CamCalib torch file (``camcalib_sa_biased_l2.ckpt``:
    ResNet-50, one FC layer) -> the state_dict of a
    :class:`~spec_tpu_torch.models.camcalib.CameraRegressorNetwork` of
    ``backbone`` and ``num_fc_layers``. With ``template`` (that model's
    fresh state_dict) mismatched or missing tensors keep the template's
    (:func:`merge_with_template`); without it a missing tensor raises."""
    from spec_tpu_torch.models.camcalib import CameraRegressorNetwork

    sd = load_torch_state_dict(path)
    if template is not None:
        return merge_with_template(sd, template)
    model = CameraRegressorNetwork(backbone=backbone,
                                   num_fc_layers=num_fc_layers)
    return select_state_dict(sd, model)


# ---------------------------------------------------------------------------
# flax variables -> torch state_dict
# ---------------------------------------------------------------------------


def _resnet_state_dict(params: dict, stats: dict, arch: str,
                       prefix: str) -> 'OrderedDict[str, torch.Tensor]':
    from spec_tpu_torch.models.backbones.resnet import _RESNETS, Bottleneck

    block, stage_sizes = _RESNETS[arch.split('-')[0]]
    n_convs = 3 if block is Bottleneck else 2
    out: 'OrderedDict[str, torch.Tensor]' = OrderedDict()

    def t(x):
        return torch.from_numpy(np.array(x, np.float32, order='C'))

    def conv(torch_name, node):
        # flax HWIO -> torch OIHW
        out[f'{prefix}{torch_name}.weight'] = t(
            np.transpose(np.asarray(node['conv']['kernel']), (3, 2, 0, 1)))

    def bn(torch_name, p, s):
        out[f'{prefix}{torch_name}.weight'] = t(p['scale'])
        out[f'{prefix}{torch_name}.bias'] = t(p['bias'])
        out[f'{prefix}{torch_name}.running_mean'] = t(s['mean'])
        out[f'{prefix}{torch_name}.running_var'] = t(s['var'])
        out[f'{prefix}{torch_name}.num_batches_tracked'] = torch.tensor(0)

    conv('conv1', params['conv1'])
    bn('bn1', params['bn1'], stats['bn1'])
    for stage, num_blocks in enumerate(stage_sizes):
        for blk in range(num_blocks):
            tn, fn = f'layer{stage + 1}.{blk}', f'layer{stage + 1}_{blk}'
            p, s = params[fn], stats[fn]
            for ci in range(1, n_convs + 1):
                conv(f'{tn}.conv{ci}', p[f'conv{ci}'])
                bn(f'{tn}.bn{ci}', p[f'bn{ci}'], s[f'bn{ci}'])
            if 'downsample_conv' in p:
                conv(f'{tn}.downsample.0', p['downsample_conv'])
                bn(f'{tn}.downsample.1', p['downsample_bn'],
                   s['downsample_bn'])
    return out


def _hrnet_state_dict(params: dict, stats: dict, arch: str,
                      prefix: str) -> 'OrderedDict[str, torch.Tensor]':
    """The JAX HRNet's variables -> official HRNet names (the inverse of
    ``convert_torch_hrnet_params``), plus the ``-conv`` head's
    ``down{b}_conv{k}`` / ``down{b}_bn{k}`` as ``downsample_stage_{b+1}
    .{k}.{0,1}`` when the variables have it."""
    from spec_tpu_torch.models.backbones.hrnet import HRNET_CONFIGS, STAGES

    cfg = HRNET_CONFIGS[arch.split('-')[0]]
    out: 'OrderedDict[str, torch.Tensor]' = OrderedDict()

    def t(x):
        return torch.from_numpy(np.array(x, np.float32, order='C'))

    def conv(torch_name, p):
        out[f'{prefix}{torch_name}.weight'] = t(
            np.transpose(np.asarray(p['conv']['kernel']), (3, 2, 0, 1)))

    def bn(torch_name, p, s):
        out[f'{prefix}{torch_name}.weight'] = t(p['scale'])
        out[f'{prefix}{torch_name}.bias'] = t(p['bias'])
        out[f'{prefix}{torch_name}.running_mean'] = t(s['mean'])
        out[f'{prefix}{torch_name}.running_var'] = t(s['var'])
        out[f'{prefix}{torch_name}.num_batches_tracked'] = torch.tensor(0)

    def conv_bn(tconv, tbn, p, s, fconv, fbn):
        conv(tconv, p[fconv])
        bn(tbn, p[fbn], s[fbn])

    conv_bn('conv1', 'bn1', params, stats, 'conv1', 'bn1')
    conv_bn('conv2', 'bn2', params, stats, 'conv2', 'bn2')
    for k in range(4):
        p, s = params[f'layer1_{k}'], stats[f'layer1_{k}']
        for ci in (1, 2, 3):
            conv_bn(f'layer1.{k}.conv{ci}', f'layer1.{k}.bn{ci}', p, s,
                    f'conv{ci}', f'bn{ci}')
        if 'downsample_conv' in p:
            conv_bn(f'layer1.{k}.downsample.0', f'layer1.{k}.downsample.1',
                    p, s, 'downsample_conv', 'downsample_bn')
    for si, name in enumerate(STAGES, start=1):
        scfg = cfg[name]
        p, s = params[f'transition_{name}'], stats[f'transition_{name}']
        for i in range(scfg['num_branches']):
            if f't{i}_conv' not in p:
                continue
            base = f'transition{si}.{i}' + ('.0' if i >= si else '')
            conv_bn(f'{base}.0', f'{base}.1', p, s, f't{i}_conv',
                    f't{i}_bn')
        for m in range(scfg['num_modules']):
            p, s = params[f'{name}_m{m}'], stats[f'{name}_m{m}']
            mbase = f'stage{si + 1}.{m}'
            for b in range(scfg['num_branches']):
                for k in range(scfg['num_blocks'][b]):
                    bp, bs = p[f'branch{b}_block{k}'], s[f'branch{b}_block{k}']
                    for ci in (1, 2):
                        conv_bn(f'{mbase}.branches.{b}.{k}.conv{ci}',
                                f'{mbase}.branches.{b}.{k}.bn{ci}', bp, bs,
                                f'conv{ci}', f'bn{ci}')
            for i in range(scfg['num_branches']):
                for j in range(scfg['num_branches']):
                    if i == j:
                        continue
                    fp, fs = p[f'fuse_{i}_{j}'], s[f'fuse_{i}_{j}']
                    base = f'{mbase}.fuse_layers.{i}.{j}'
                    if j > i:
                        conv_bn(f'{base}.0', f'{base}.1', fp, fs, 'conv',
                                'bn')
                    else:
                        for k in range(i - j):
                            conv_bn(f'{base}.{k}.0', f'{base}.{k}.1', fp, fs,
                                    f'conv{k}', f'bn{k}')
    for b in range(4):
        k = 0
        while f'down{b}_conv{k}' in params:
            conv_bn(f'downsample_stage_{b + 1}.{k}.0',
                    f'downsample_stage_{b + 1}.{k}.1', params, stats,
                    f'down{b}_conv{k}', f'down{b}_bn{k}')
            k += 1
    return out


def _trunk_state_dict(params: dict, stats: dict, backbone: str,
                      prefix: str) -> 'OrderedDict[str, torch.Tensor]':
    if backbone.startswith('hrnet'):
        return _hrnet_state_dict(params, stats, backbone, prefix)
    return _resnet_state_dict(params, stats, backbone, prefix)


def _yolo_state_dict(params: dict, stats: dict
                     ) -> 'OrderedDict[str, torch.Tensor]':
    """The JAX ``YoloV3``'s variables -> :class:`~spec_tpu_torch.models.
    detector.YoloV3`'s state_dict: ``conv{i}`` HWIO kernels to OIHW,
    ``bn{i}`` scale, bias, mean and var."""
    out: 'OrderedDict[str, torch.Tensor]' = OrderedDict()
    n = sum(1 for k in params if k.startswith('conv'))
    for i in range(n):
        node = params[f'conv{i}']
        out[f'conv{i}.weight'] = torch.from_numpy(np.array(np.transpose(
            np.asarray(node['kernel'], np.float32), (3, 2, 0, 1)),
            order='C'))
        if 'bias' in node:
            out[f'conv{i}.bias'] = torch.from_numpy(
                np.asarray(node['bias'], np.float32).copy())
        if f'bn{i}' in params:
            p, s = params[f'bn{i}'], stats[f'bn{i}']
            for name, leaf in (('weight', p['scale']), ('bias', p['bias']),
                               ('running_mean', s['mean']),
                               ('running_var', s['var'])):
                out[f'bn{i}.{name}'] = torch.from_numpy(
                    np.asarray(leaf, np.float32).copy())
            out[f'bn{i}.num_batches_tracked'] = torch.tensor(0)
    return out


def _dense(out: dict, torch_name: str, node: dict) -> None:
    """flax Dense (kernel (in, out)) -> torch Linear (weight (out, in))."""
    out[f'{torch_name}.weight'] = torch.from_numpy(
        np.array(np.asarray(node['kernel'], np.float32).T, order='C'))
    out[f'{torch_name}.bias'] = torch.from_numpy(
        np.asarray(node['bias'], np.float32).copy())


def state_dict_from_flax(variables: dict, kind: str,
                         backbone: str = 'resnet50'
                         ) -> 'OrderedDict[str, torch.Tensor]':
    """JAX package variables ({'params', 'batch_stats'}, numpy or jax
    arrays) -> this package's state_dict.

    kind: 'resnet' or 'hrnet' (a bare trunk of ``backbone``, for
    ``models.backbones.get_backbone``), 'camcalib'
    (:class:`~spec_tpu_torch.models.camcalib.CameraRegressorNetwork`),
    'hmr' (:class:`~spec_tpu_torch.models.hmr.HMR` with a ResNet or
    HRNet ``backbone``) or 'yolo'
    (:class:`~spec_tpu_torch.models.detector.YoloV3`).
    """
    params, stats = variables['params'], variables['batch_stats']
    if kind in ('resnet', 'hrnet'):
        if kind != ('hrnet' if backbone.startswith('hrnet') else 'resnet'):
            raise ValueError(f'kind {kind!r} does not match backbone '
                             f'{backbone!r}')
        return _trunk_state_dict(params, stats, backbone, '')
    if kind == 'yolo':
        return _yolo_state_dict(params, stats)
    if kind not in ('camcalib', 'hmr'):
        raise ValueError(f"unknown kind {kind!r}; use 'resnet', 'hrnet', "
                         "'camcalib', 'hmr' or 'yolo'")
    trunk = 'HRNet_0' if backbone.startswith('hrnet') else 'ResNet_0'
    out = _trunk_state_dict(params[trunk], stats[trunk], backbone,
                            'backbone.')
    if kind == 'camcalib':
        for head in ('fc_vfov', 'fc_pitch', 'fc_roll'):
            n = sum(1 for k in params if k.startswith(f'{head}_'))
            for i in range(n):
                _dense(out, head if n == 1 else f'{head}.{i}',
                       params[f'{head}_{i}'])
        return out
    hp = params['head']
    for name in ('init_pose', 'init_shape', 'init_cam'):
        out[f'head.{name}'] = torch.from_numpy(
            np.asarray(hp[name], np.float32).copy())
    for name in ('fc1', 'fc2', 'decpose', 'decshape', 'deccam',
                 'decpose_var', 'decshape_var'):
        if name in hp:          # the last two with ``estimate_var`` only
            _dense(out, f'head.{name}', hp[name])
    return out


def assets_from_jax(assets):
    """``spec_tpu.core.smpl.SMPLAssets`` -> this package's SMPLAssets on
    the CPU. Packed kernel operands are not carried over: attach them
    with :func:`spec_tpu_torch.core.smpl.with_packed_lbs`."""
    from spec_tpu_torch.core.smpl import SMPLAssets

    def t(x, dtype=np.float32):
        return None if x is None else torch.from_numpy(
            np.array(x, dtype=dtype))

    return SMPLAssets(
        v_template=t(assets.v_template),
        shapedirs=t(assets.shapedirs),
        posedirs=t(assets.posedirs),
        j_regressor=t(assets.j_regressor),
        lbs_weights=t(assets.lbs_weights),
        parents=tuple(int(p) for p in assets.parents),
        faces=t(assets.faces, np.int32),
        extra_vertex_ids=(None if assets.extra_vertex_ids is None
                          else tuple(int(i) for i in
                                     assets.extra_vertex_ids)),
        j_regressor_extra=t(assets.j_regressor_extra),
        j_regressor_h36m=t(assets.j_regressor_h36m),
    )


# ---------------------------------------------------------------------------
# The trainer's own checkpoints
# ---------------------------------------------------------------------------
#
# The JAX package's layout: ``<dir>/step_NNNNNNNN/`` per checkpoint, with
# the trainer's ``meta.json`` beside them. Each step directory here holds
# torch files: ``model.pt`` (the model's state_dict), ``optimizer.pt``
# and ``state.json`` (the step). It is written under a temporary name and
# renamed into place, so a directory named ``step_NNNNNNNN`` is never
# half-written; a JAX orbax step directory has no ``model.pt``.

MODEL_FILE, OPTIMIZER_FILE, STATE_FILE = 'model.pt', 'optimizer.pt', \
    'state.json'


def _step_dirs(directory: str) -> dict:
    """{step: dirname} of the complete checkpoints (an interrupted save
    leaves ``step_NNNNNNNN.tmp-*``, which never counts)."""
    out = {}
    try:
        entries = os.listdir(directory)
    except (FileNotFoundError, NotADirectoryError):
        return out
    for d in entries:
        suffix = d[len('step_'):]
        if d.startswith('step_') and suffix.isdigit():
            out[int(suffix)] = d
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _step_dirs(directory)
    return max(steps) if steps else None


def _keep_latest(directory: str, keep: int) -> None:
    steps = _step_dirs(directory)
    for n in sorted(steps)[:-keep]:
        shutil.rmtree(os.path.join(directory, steps[n]), ignore_errors=True)


def save_checkpoint(directory: str, state, step: int, keep: int = 30) -> str:
    """Write ``state`` (a ``train.state.TrainState``) as
    ``<directory>/step_NNNNNNNN`` (replacing one of the same step) and
    keep the ``keep`` most recent. Returns the step directory.

    Under a process group every rank calls it: rank 0 writes (when the
    optimizer's slots are sharded, ``parallel/fsdp.py``, every rank
    first takes part in their gather), and every rank waits at a barrier
    until the checkpoint is in place, so a resume on any rank finds
    it."""
    from spec_tpu_torch import parallel as par

    directory = os.path.abspath(directory)
    final = os.path.join(directory, f'step_{step:08d}')
    rank0 = par.process_index() == 0
    optimizer = (state.optimizer.state_dict()
                 if rank0 or state.optimizer.layout is not None else None)
    if rank0:
        _write_checkpoint(directory, final, state, optimizer, keep)
    par.barrier()
    return final


def _write_checkpoint(directory, final, state, optimizer, keep) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = f'{final}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({k: v.detach().cpu() for k, v in
                state.model.state_dict().items()},
               os.path.join(tmp, MODEL_FILE))
    torch.save(optimizer, os.path.join(tmp, OPTIMIZER_FILE))
    with open(os.path.join(tmp, STATE_FILE), 'w') as f:
        json.dump({'step': int(state.step)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _keep_latest(directory, keep)


def _step_dir(directory: str, step: Optional[int]) -> str:
    directory = os.path.abspath(directory)
    steps = _step_dirs(directory)
    if not steps:
        raise FileNotFoundError(f'no checkpoints in {directory}')
    step = max(steps) if step is None else step
    path = os.path.join(directory, f'step_{step:08d}')
    if not os.path.exists(os.path.join(path, MODEL_FILE)):
        if not os.path.isdir(path):
            raise FileNotFoundError(f'no checkpoint of step {step} in '
                                    f'{directory}')
        raise ValueError(
            f'{path} is not a spec_tpu_torch checkpoint (no {MODEL_FILE}): '
            'a JAX package (orbax) checkpoint directory cannot be read by '
            'the port; convert its weights with state_dict_from_flax')
    return path


def load_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """The given (or latest) checkpoint: {'step', 'model' (a state_dict),
    'optimizer'} on the CPU."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, STATE_FILE)) as f:
        saved_step = int(json.load(f)['step'])
    return {'step': saved_step,
            'model': torch.load(os.path.join(path, MODEL_FILE),
                                map_location='cpu', weights_only=True),
            'optimizer': torch.load(os.path.join(path, OPTIMIZER_FILE),
                                    map_location='cpu', weights_only=True)}


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load the given (or latest) checkpoint into ``state`` in place
    (model, optimizer, step) and return it."""
    ckpt = load_checkpoint(directory, step)
    state.model.load_state_dict(ckpt['model'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.step = ckpt['step']
    return state


def load_checkpoint_variables(directory: str,
                              step: Optional[int] = None) -> dict:
    """The model state_dict of a trainer checkpoint directory
    (``spec_eval --ckpt <logdir>/checkpoints``, ``build_hmr``)."""
    path = _step_dir(directory, step)
    return torch.load(os.path.join(path, MODEL_FILE), map_location='cpu',
                      weights_only=True)


def find_resume_checkpoint_dir(current_logdir: str,
                               explicit: Optional[str] = None):
    """A checkpoint directory to resume from: ``explicit``
    (TRAINING.RESUME: a checkpoints dir, a run dir holding one, or a
    single ``step_NNNNNNNN`` dir, which pins that step), else the most
    recently modified sibling run of ``current_logdir`` with
    checkpoints. Returns ``(checkpoints_dir, step or None)`` or None."""
    if explicit:
        base = os.path.basename(os.path.normpath(explicit))
        if base.startswith('step_') and os.path.isdir(explicit):
            suffix = base[len('step_'):]
            if suffix.isdigit():
                return os.path.dirname(os.path.abspath(explicit)), \
                    int(suffix)
        for c in (explicit, os.path.join(explicit, 'checkpoints')):
            if latest_step(c) is not None:
                return c, None
        return None
    parent = os.path.dirname(os.path.abspath(current_logdir))
    if not os.path.isdir(parent):
        return None
    runs = [os.path.join(parent, d) for d in os.listdir(parent)
            if os.path.join(parent, d) != os.path.abspath(current_logdir)]
    runs = [r for r in runs if os.path.isdir(r)]
    runs.sort(key=os.path.getmtime, reverse=True)
    for r in runs:
        ck = os.path.join(r, 'checkpoints')
        if latest_step(ck) is not None:
            return ck, None
    return None
