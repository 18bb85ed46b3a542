"""Driver of ``SpecPredictor.predict`` with HMR 2.0 as stage 2 (ViT-H/16
trunk, transformer-decoder head): ``drivers/predict.py``'s closed loop,
calls, work list and comparison, with its own set-up, operations and
reference networks.

Set-up checks first that the program has the decoder head, so a program
without HMR 2.0 fails at once. The reference HMR 2.0
(``benchmark/reference/hmr2.py``) is built on the device and gets the
seeded weights (``weights.network_state`` with the configuration's
``init``: LayerNorm scales through its ``batchnorm_gamma``); there is no
BatchNorm to calibrate. Its mean parameters decode to identity
rotations, shape 0 and the crop camera (0.9, 0, 0). CamCalib is built
and calibrated as in ``drivers/predict.py``, with ``camcalib_init``, the
spec-resnet50 configuration's ``init``, so stage 1 is that cell's.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import traffic as T
from benchmark import weights as W
from benchmark import work, work_hmr2
from benchmark.drivers import predict
from benchmark.drivers.predict import compare  # noqa: F401
from benchmark.reference import hmr2, image, nets
from benchmark.reference import predict as R

_attend = hmr2.attend

# Faults the calibration plants in the reference (each a reference
# function and what takes its place), which the limits must catch.
FAULTS = {
    'positions_without_class_row': ('positions', lambda pos: pos[:, 1:]),
    'attention_scale_1': ('attend',
                          lambda q, k, v, scale: _attend(q, k, v, 1.0)),
    'context_normalized_twice': (
        'context_tokens', lambda t: F.layer_norm(t, t.shape[-1:])),
}


@contextlib.contextmanager
def planted(name: str):
    """The reference with the fault ``name`` in place, restored after."""
    attr, fn = FAULTS[name]
    old = getattr(hmr2, attr)
    setattr(hmr2, attr, fn)
    try:
        yield
    finally:
        setattr(hmr2, attr, old)


def mean_params(model: hmr2.HMR2) -> None:
    head = model.head
    head.init_body_pose.copy_(
        torch.tensor([1.0, 0, 0, 0, 1.0, 0]).repeat(24)[None])
    head.init_betas.zero_()
    head.init_cam.copy_(torch.tensor([[0.9, 0.0, 0.0]]))


class Driver(predict.Driver):

    def _reference_networks(self):
        cc, hc = self.cfg['camcalib'], self.cfg['hmr']
        r = T.rng(self.seed, 3)
        h, w = self.traffic.sizes[0]
        frames = T.scene(r, h, w, predict.CALIBRATION_FRAMES)
        with R.precision(False), torch.no_grad():
            x = torch.stack([image.resize_min_side(
                torch.from_numpy(f).to(self.device), cc['min_size'])
                for f in frames]).float() / 255.0
            cam = nets.CamCalib(cc['backbone'], cc['bins']).to(self.device)
            cam_state = W.calibrated(cam, W.network_state(
                cam, self.seed, 4, self.cfg['camcalib_init'], self.device),
                image.normalize(x))
            with torch.device(self.device):
                hmr = hmr2.HMR2.from_config(hc)
            mean_params(hmr)
            hmr.load_state_dict(W.network_state(
                hmr, self.seed, 5, self.cfg['init'], self.device),
                strict=False)
        return cam.eval(), cam_state, hmr.eval(), hmr.state_dict()

    def setup(self) -> None:
        # A program without HMR 2.0 stops here, before any work.
        from spec_tpu_torch.models.heads import transformer_head  # noqa
        from spec_tpu_torch.serving import SpecPredictor

        sc, cc, hc = self.cfg['smpl'], self.cfg['camcalib'], self.cfg['hmr']
        self.assets = W.smpl_assets(self.seed, sc['num_vertices'],
                                    self.device)
        (self.ref_cam, cam_state, self.ref_hmr,
         hmr_state) = self._reference_networks()
        smpl_dir = self.data_dir / 'smpl'
        smpl_dir.mkdir(parents=True, exist_ok=True)
        W.write_smpl_npz(self.assets, smpl_dir / 'SMPL_NEUTRAL.npz')
        np.save(self.data_dir / 'J_regressor_extra.npy',
                self.assets['j_regressor_extra'].cpu().numpy())
        os.environ['SPEC_DATA_ROOT'] = str(self.data_dir)
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        self.pred = SpecPredictor(
            smpl_model_dir=str(smpl_dir), backbone=hc['backbone'],
            head=hc['head'], use_cam_feats=hc['use_cam_feats'],
            camcalib_backbone=cc['backbone'], loss_type=cc['loss_type'],
            img_res=hc['img_res'], batch_size=self.cfg['batch_size'],
            min_size=cc['min_size'], dtype=torch.float32,
            device=self.device, **self.settings)
        self.pred.camcalib.load_state_dict(cam_state)
        self.pred.spec.load_state_dict(hmr_state)
        del hmr_state
        for _ in range(2):
            for call in self.traffic.warmup_calls():
                self.pred.predict(call.frames, call.boxes, stream='warm-up')
        self.pred.reset_camera_stream(all_streams=True)

    # -- work --------------------------------------------------------------

    def flops(self, call) -> float:
        """CamCalib on the call's keyframes, HMR 2.0 and SMPL on its
        persons (padding not counted)."""
        cc = self.cfg['camcalib']
        f = sum(work.camcalib_flops(cc['backbone'], h, w)
                for h, w in self.stage1_frames(call))
        return f + call.persons * work_hmr2.person_flops(
            self.cfg['hmr'], self.cfg['smpl']['num_vertices'])

    def attention_bound_s(self, call) -> float:
        """The least time of the call's attention (its persons)."""
        return work_hmr2.attention_bound_s(call.persons, self.cfg['hmr'])

    # -- the check -----------------------------------------------------------

    def faults(self, items) -> dict:
        """The reference's outputs with each of :data:`FAULTS` planted."""
        out = {}
        for name in FAULTS:
            with planted(name):
                out[name] = self.reference(items)
        return out
