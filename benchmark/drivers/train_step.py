"""Driver of SPEC's train step (``spec_tpu_torch.train.steps.
make_spec_train_step``): one caller, one step after another, each on the
next batch of the pool, copied from pinned host memory as a trainer's
loader hands it over.

Set-up makes the seeded weights and SMPL assets, builds the regressor,
its Adam state and the step, and drives that same state through its
first three steps by the window's own call (the first captures the
step's CUDA graph), recording each step's loss, the first gradient as
the optimizer got it (its first moment after one step) and every
tensor's change over the three steps. The window then goes on from step
four. The check follows the same three steps with the plain reference
and compares.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark import traffic as T
from benchmark import weights as W
from benchmark import work
from benchmark.reference import nets
from benchmark.reference import predict as R
from benchmark.reference import train as RT

FIRST_STEPS = 3
CALIBRATION_CROPS = 16


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 data_dir: Path):
        self.cfg, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.data_dir = Path(data_dir)
        self.batches = T.TrainBatches(mix, seed)
        self.B = int(mix['batch'])
        self.step = self.state = None

    def _batch(self, k: int) -> dict:
        return {n: v.to(self.device, non_blocking=True)
                for n, v in self.batches.pool[k % len(self.batches.pool)]
                .items()}

    def _generator(self) -> torch.Generator:
        return W.generator(self.seed, 6, self.device)

    def setup(self) -> None:
        hc = self.cfg['hmr']
        self.assets = W.smpl_assets(self.seed, self.cfg['smpl']
                                    ['num_vertices'], self.device)
        crops = self.batches.pool[0]['img'][:CALIBRATION_CROPS]
        with R.precision(False):
            ref = nets.HMR(hc['backbone'], hc['n_iter'],
                           hc['hidden']).to(self.device)
            W.mean_params(ref)
            self.init_state = W.calibrated(ref, W.network_state(
                ref, self.seed, 5, self.cfg['init'],
                self.device), crops.to(self.device).permute(0, 3, 1, 2))
        del ref
        smpl_dir = self.data_dir / 'smpl'
        smpl_dir.mkdir(parents=True, exist_ok=True)
        W.write_smpl_npz(self.assets, smpl_dir / 'SMPL_NEUTRAL.npz')
        jre = self.data_dir / 'J_regressor_extra.npy'
        np.save(jre, self.assets['j_regressor_extra'].cpu().numpy())
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)

        from spec_tpu_torch.core import smpl as S
        from spec_tpu_torch.models.hmr import HMR
        from spec_tpu_torch.train import (adam, create_train_state,
                                          make_spec_train_step)

        model = HMR(backbone=hc['backbone'], use_cam=hc['use_cam'],
                    use_cam_feats=hc['use_cam_feats'], img_res=hc['img_res'])
        model.load_state_dict(self.init_state)
        model = model.to(self.device).train()
        self.state = create_train_state(
            model, adam(float(self.mix['learning_rate'])))
        assets = S.load_smpl_assets(str(smpl_dir),
                                    j_regressor_extra_path=str(jre))
        self.step = make_spec_train_step(model, assets)
        self.gen = self._generator()
        self.record = self._first_steps()

    def _names(self) -> list:
        """The optimizer's tensors by name, in its order (the parameters,
        then the trainable mean-parameter buffers)."""
        from spec_tpu_torch.train.state import INIT_BUFFERS

        model = self.state.model
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        names += [n for n, _ in model.named_buffers()
                  if n.rsplit('.', 1)[-1] in INIT_BUFFERS]
        return names

    def _first_steps(self) -> dict:
        opt = self.state.optimizer
        names = self._names()
        start = [p.detach().clone() for p in opt.params]
        losses, grads = [], None
        for k in range(FIRST_STEPS):
            losses.append(self.run(k)[1])
            if k == 0:
                # Adam's first moment after one step is (1 - b1) g
                from spec_tpu_torch.train.state import B1
                grads = {n: (m / (1.0 - B1)).clone()
                         for n, m in zip(names, opt.slots['mu'])}
        change = {n: p.detach() - s
                  for n, p, s in zip(names, opt.params, start)}
        return {'losses': losses, 'grads': grads, 'change': change}

    def calls(self):
        k = FIRST_STEPS
        while True:
            yield Step(k, self.B)
            k += 1

    def run(self, k) -> tuple:
        """One train step on batch ``k``; returns (crops, its loss)."""
        k = getattr(k, 'index', k)
        _, metrics = self.step(self.state, self._batch(k), self.gen)
        return self.B, float(metrics['loss/total_loss'])

    def expected(self, call) -> int:
        return self.B

    def release(self) -> None:
        self.step = self.state = None

    # -- work --------------------------------------------------------------

    def flops(self, call) -> float:
        hc = self.cfg['hmr']
        return self.B * work.train_crop_flops(
            hc['backbone'], hc['img_res'], self.cfg['smpl']['num_vertices'])

    def k1_bound_s(self, call) -> float:
        """Two K1 passes a step: the ground-truth and the predicted
        meshes."""
        return 2 * work.k1_bound_s(self.B, self.cfg['smpl']['num_vertices'])

    # -- the check ---------------------------------------------------------

    def observed(self, items) -> list:
        return [self.record]

    def _reference(self, tf32: bool, rows=None) -> dict:
        hc = self.cfg['hmr']
        batches = [self._batch(k) for k in range(FIRST_STEPS)]
        if rows is not None:
            batches = [{n: v[rows] for n, v in b.items()} for b in batches]
        with R.precision(tf32):
            ref = nets.HMR(hc['backbone'], hc['n_iter'],
                           hc['hidden']).to(self.device)
            ref.load_state_dict(self.init_state)
            out = RT.steps(ref, self.assets, batches, self._generator(),
                           float(self.mix['learning_rate']))
        return out

    def reference(self, items, tf32: bool = False) -> list:
        """The reference's first three steps from the same state, batches
        and dropout generator (in TF32 for the control)."""
        return [self._reference(tf32)]

    def faults(self, items) -> dict:
        """Half of each batch left out, the loss the mean over the rest
        (read by the reference put in the program's place)."""
        return {'half_batch': [self._reference(False,
                                               slice(0, self.B // 2))]}


class Step:
    def __init__(self, index: int, crops: int):
        self.index, self.persons = index, crops


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def compare(outputs: list, refs: list) -> dict:
    """Each step's loss (relative gap); the first gradient's and the
    three steps' change's norms tensor by tensor, by the worst tensor:
    the gap between the program's norm and the reference's over the
    larger of the reference's norm of that tensor and of the median
    tensor. Tensors whose reference gradient is under a thousandth of
    the median tensor's (round-off under Adam) are left out of the
    change."""
    (out,), (ref,) = outputs, refs
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(out['losses'], ref['losses']))

    def worst(mine, theirs, keep=None):
        a, b = _norms(mine), _norms(theirs)
        keys = [k for k in b if keep is None or k in keep]
        med = float(np.median([b[k] for k in keys]))
        gaps = [abs(a[k] - b[k]) / max(b[k], med) if math.isfinite(a[k])
                else math.inf for k in keys]
        return max(gaps)

    g = _norms(ref['grads'])
    med = float(np.median(list(g.values())))
    moving = {k for k, v in g.items() if v >= 1e-3 * med}
    return {'loss': loss, 'grad_norm': worst(out['grads'], ref['grads']),
            'change_norm': worst(out['change'], ref['change'], moving)}
