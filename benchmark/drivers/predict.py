"""Driver of ``SpecPredictor.predict``: one caller in a closed loop, each
call the next of the mix (a clip of one stream, or a batch of photos).

Set-up makes the seeded weights and SMPL assets, writes the assets where
the program reads a released SMPL file, builds the predictor from the
configuration, loads the weights into its networks and warms it up on
every shape the mix can produce. A call returns the persons it
produced. The check runs the plain reference on sampled calls after the
window and compares, frame by frame and person by person.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from benchmark import traffic as T
from benchmark import weights as W
from benchmark import work
from benchmark.reference import image, nets
from benchmark.reference import predict as R

STREAM = 'bench'
CALIBRATION_FRAMES, CALIBRATION_CROPS = 2, 16


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 data_dir: Path):
        self.cfg, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.data_dir = Path(data_dir)
        self.traffic = T.Traffic(mix, seed)
        self.settings = T.settings(mix)
        self.pred = None

    # -- set-up ------------------------------------------------------------

    def _reference_networks(self):
        """The plain networks with the seeded weights, BatchNorm
        statistics measured on seeded frames of the mix."""
        cc, hc = self.cfg['camcalib'], self.cfg['hmr']
        init = self.cfg['init']
        r = T.rng(self.seed, 3)
        h, w = self.traffic.sizes[0]
        frames = T.scene(r, h, w, CALIBRATION_FRAMES)
        with R.precision(False):
            x = torch.stack([image.resize_min_side(
                torch.from_numpy(f).to(self.device), cc['min_size'])
                for f in frames]).float() / 255.0
            cam = nets.CamCalib(cc['backbone'], cc['bins']).to(self.device)
            cam_state = W.calibrated(cam, W.network_state(
                cam, self.seed, 4, init, self.device), image.normalize(x))
            res = hc['img_res']
            ys = r.integers(0, h - res, CALIBRATION_CROPS)
            xs = r.integers(0, w - res, CALIBRATION_CROPS)
            crops = torch.stack([torch.from_numpy(
                frames[k % CALIBRATION_FRAMES][y:y + res, x:x + res])
                for k, (y, x) in enumerate(zip(ys, xs))]).to(self.device)
            hmr = nets.HMR(hc['backbone'], hc['n_iter'],
                           hc['hidden']).to(self.device)
            W.mean_params(hmr)
            hmr_state = W.calibrated(hmr, W.network_state(
                hmr, self.seed, 5, init, self.device),
                image.normalize(crops.float() / 255.0))
        return cam.eval(), cam_state, hmr.eval(), hmr_state

    def setup(self) -> None:
        sc = self.cfg['smpl']
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

        from spec_tpu_torch.serving import SpecPredictor

        cc, hc = self.cfg['camcalib'], self.cfg['hmr']
        self.pred = SpecPredictor(
            smpl_model_dir=str(smpl_dir), backbone=hc['backbone'],
            use_cam_feats=hc['use_cam_feats'],
            camcalib_backbone=cc['backbone'], loss_type=cc['loss_type'],
            img_res=hc['img_res'], batch_size=self.cfg['batch_size'],
            min_size=cc['min_size'], dtype=torch.float32,
            device=self.device, **self.settings)
        self.pred.camcalib.load_state_dict(cam_state)
        self.pred.spec.load_state_dict(hmr_state)
        for _ in range(2):
            for call in self.traffic.warmup_calls():
                self.pred.predict(call.frames, call.boxes, stream='warm-up')
        self.pred.reset_camera_stream(all_streams=True)

    def calls(self):
        return self.traffic.calls()

    # -- the window ----------------------------------------------------------

    def run(self, call):
        """One call; returns (persons returned, the call's output)."""
        out = self.pred.predict(call.frames, call.boxes, stream=STREAM)
        return sum(len(f) for f in out), out

    def expected(self, call) -> int:
        return call.persons

    def release(self) -> None:
        self.pred = None

    # -- work --------------------------------------------------------------

    def stage1_frames(self, call) -> list:
        """The resized sizes of the frames stage 1 runs on."""
        keys = image.keyframes(call.frames, call.start,
                               self.settings['camcalib_every'],
                               self.settings['cut_threshold'])
        m = self.cfg['camcalib']['min_size']
        out = []
        for i in keys:
            h, w = call.frames[i].shape[:2]
            s = m / min(h, w)
            out.append((round(h * s), round(w * s)))
        return out

    def flops(self, call) -> float:
        """The model's operations for the call: CamCalib on its keyframes,
        the regressor and SMPL on its persons (padding not counted)."""
        cc, hc = self.cfg['camcalib'], self.cfg['hmr']
        f = sum(work.camcalib_flops(cc['backbone'], h, w)
                for h, w in self.stage1_frames(call))
        return f + call.persons * work.person_flops(
            hc['backbone'], hc['img_res'], self.cfg['smpl']['num_vertices'])

    def k1_bound_s(self, call) -> float:
        """The least K1 time for the call: one pass over all its persons."""
        return work.k1_bound_s(call.persons, self.cfg['smpl']['num_vertices'])

    # -- the check -----------------------------------------------------------

    def observed(self, items) -> list:
        """The program's outputs of the sampled calls."""
        return [out for _, out in items]

    def reference(self, items, tf32: bool = False) -> list:
        """The plain reference's outputs of the sampled calls (in TF32 for
        the control)."""
        cc, hc = self.cfg['camcalib'], self.cfg['hmr']
        outs = []
        with R.precision(tf32):
            for call, _ in items:
                cams = R.stream_cameras(
                    self.ref_cam, call.frames, call.start,
                    self.settings['camcalib_every'],
                    self.settings['cut_threshold'], cc['min_size'],
                    self.device)
                people = R.persons(self.ref_hmr, self.assets, call.frames,
                                   call.boxes, cams, hc['img_res'],
                                   self.device)
                for frame, cam in zip(people, cams):
                    for p in frame:
                        p['camera'] = cam
                outs.append(people)
        return outs

    def faults(self, items) -> dict:
        """Faults read by the reference put in the program's place: none
        for predict (its faults are planted in the program by the
        tests)."""
        return {}


# Compared number -> output key.
FIELDS = {'pose6d': 'pred_pose_6d',
          'shape': 'pred_shape', 'cam': 'pred_cam',
          'verts_m': 'smpl_vertices', 'joints3d_m': 'smpl_joints3d',
          'joints2d_px': 'smpl_joints2d'}


def compare(outputs: list, refs: list) -> dict:
    """The widest gaps between the program's outputs and the reference's
    over every compared call, frame and person: the cameras (angles in
    radians, the focal length relative), the regressor's pose (its 6D
    output: the rotation matrices Gram-Schmidt makes of it amplify
    round-off where its two columns lie near parallel, and reach the
    mesh and joints compared below), shape and crop camera, SMPL's vertices and 3D joints
    (m), the 2D joints in the frame (px); and the persons missing or
    extra."""
    gaps = dict.fromkeys(['camera_rad', 'focal_rel', *FIELDS], 0.0)

    def widen(name, d):
        d = np.abs(np.asarray(d, np.float64))
        gap = float(d.max()) if d.size else 0.0
        gaps[name] = max(gaps[name], gap if np.isfinite(gap) else np.inf)

    missing = 0
    for out, ref in zip(outputs, refs):
        for frame, rframe in zip(out, ref):
            missing += abs(len(frame) - len(rframe))
            for p, q in zip(frame, rframe):
                a, b = p['camera'], q['camera']
                widen('camera_rad', [a[k] - b[k]
                                     for k in ('vfov', 'pitch', 'roll')])
                widen('focal_rel', (a['f_pix'] - b['f_pix']) / b['f_pix'])
                for name, key in FIELDS.items():
                    widen(name, np.asarray(p[key], np.float64)
                          - np.asarray(q[key], np.float64))
    gaps['missing'] = float(missing)
    return gaps
