"""The one traffic generator: a mix is a JSON file of parameters under
``benchmark/traffic/``, and this module turns it and a seed into the
calls of a run.

A call is ``frames_per_call`` frames with person boxes ``[cx, cy, w,
h]``. Parameters:

* ``sizes``: frame sizes ``[h, w]``. ``size_per: "call"``: all frames of
  a call share one size, the sizes taken in turn from a shuffled deck
  (a video clip); ``"frame"``: ``sizes`` is the multiset of one call's
  frame sizes, shuffled within the call (a batch of photos).
* ``persons: [lo, hi]``, ``persons_per``: ``"call"``: the clip's N
  persons, N from a shuffled deck of lo..hi, appear in every frame;
  ``"frame"``: each frame draws its own count from the deck.
* ``box_height_px: [lo, hi]``, ``box_aspect`` (width / height),
  ``jitter_px``: a clip's person moves by up to that many pixels per
  frame. Boxes lie inside their frame.
* ``scene: "clip"``: a call's frames are one scene's ``frames_per_call``
  frames (a coarse color field, then noise per frame); ``"photo"``: each
  frame is a photo of its size from a deck. ``scenes``: how many scenes
  or photos of each size the pool holds.
* ``camcalib_every``, ``cut_threshold``: the stream's keyframe rule, as
  the job sets it on the predictor.

Decks make every seed offer the same sizes and person counts in another
order, so seeds change the order of the work and not its amount.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / 'traffic'


def load(name: str, root: Path = TRAFFIC_DIR) -> dict:
    return json.loads((Path(root) / f'{name}.json').read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, stream])


class Deck:
    """Values dealt in a shuffled order, reshuffled when used up."""

    def __init__(self, values, rng: np.random.Generator):
        self.values, self.rng, self.left = list(values), rng, []

    def next(self):
        if not self.left:
            self.left = [self.values[i]
                         for i in self.rng.permutation(len(self.values))]
        return self.left.pop()


@dataclasses.dataclass
class Call:
    index: int
    frames: list            # (h, w, 3) uint8 arrays
    boxes: list             # (n, 4) float32 [cx, cy, w, h] per frame
    start: int              # the stream index of the first frame

    @property
    def persons(self) -> int:
        return sum(len(b) for b in self.boxes)


def scene(r: np.random.Generator, h: int, w: int, n: int) -> list:
    """``n`` frames of one scene: a 9 x 16 field of random colors blown up
    to h x w, with fresh noise of +-12 levels per frame."""
    gh, gw = 9, 16
    field = r.integers(0, 256, (gh, gw, 3), dtype=np.int16)
    base = np.repeat(np.repeat(field, -(-h // gh), 0), -(-w // gw), 1)[:h, :w]
    return [np.clip(base + r.integers(-12, 13, (h, w, 3), dtype=np.int16),
                    0, 255).astype(np.uint8) for _ in range(n)]


class Traffic:
    """The calls of one mix and seed, in order (``calls()``), and the
    warm-up calls that cover every shape the mix can produce."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = seed
        self.fpc = int(params['frames_per_call'])
        self.sizes = [tuple(s) for s in params['sizes']]
        if params['size_per'] == 'frame' and len(self.sizes) != self.fpc:
            raise ValueError('size_per "frame" takes one size per frame')
        lo, hi = params['persons']
        self.counts = list(range(int(lo), int(hi) + 1))
        pool = rng(seed, 0)
        n = int(params['scenes'])
        clip = params['scene'] == 'clip'
        self.pool = {s: [scene(pool, *s, self.fpc if clip else 1)
                         for _ in range(n)] for s in sorted(set(self.sizes))}

    # -- one call --------------------------------------------------------

    def _boxes(self, r, h, w, n):
        lo, hi = self.p['box_height_px']
        bh = r.uniform(lo, min(hi, h - 2), n)
        bw = bh * float(self.p['box_aspect'])
        cx = r.uniform(bw / 2 + 1, w - bw / 2 - 1)
        cy = r.uniform(bh / 2 + 1, h - bh / 2 - 1)
        return np.stack([cx, cy, bw, bh], 1).astype(np.float32)

    def _jitter(self, r, boxes, h, w):
        j = float(self.p['jitter_px'])
        b = boxes.copy()
        b[:, :2] += r.uniform(-j, j, (len(b), 2)).astype(np.float32)
        b[:, 0] = np.clip(b[:, 0], b[:, 2] / 2 + 1, w - b[:, 2] / 2 - 1)
        b[:, 1] = np.clip(b[:, 1], b[:, 3] / 2 + 1, h - b[:, 3] / 2 - 1)
        return b

    def _call(self, r, k, sizes, counts, scene_decks):
        """A call of frames of ``sizes`` with ``counts`` persons (one count
        for the clip, or one per frame)."""
        frames, boxes = [], []
        if self.p['scene'] == 'clip':
            pick = scene_decks[sizes[0]].next()
            frames = list(self.pool[sizes[0]][pick])
        else:
            frames = [self.pool[s][scene_decks[s].next()][0] for s in sizes]
        if self.p['persons_per'] == 'call':
            h, w = sizes[0]
            base = self._boxes(r, h, w, counts[0])
            for _ in range(self.fpc):
                base = self._jitter(r, base, h, w)
                boxes.append(base)
        else:
            boxes = [self._boxes(r, *s, c) for s, c in zip(sizes, counts)]
        return Call(k, frames, boxes, k * self.fpc)

    def _decks(self, r):
        n = int(self.p['scenes'])
        return {s: Deck(range(n), r) for s in self.pool}

    def calls(self):
        """The run's calls, one after another, without end."""
        r = rng(self.seed, 1)
        size_deck, count_deck = Deck(self.sizes, r), Deck(self.counts, r)
        scene_decks = self._decks(r)
        k = 0
        while True:
            if self.p['size_per'] == 'call':
                sizes = [size_deck.next()] * self.fpc
            else:
                sizes = [self.sizes[i] for i in r.permutation(self.fpc)]
            n = 1 if self.p['persons_per'] == 'call' else self.fpc
            counts = [count_deck.next() for _ in range(n)]
            yield self._call(r, k, sizes, counts, scene_decks)
            k += 1

    def warmup_calls(self) -> list:
        """One call for every person total the mix can produce, at every
        frame size it uses: the shapes the program meets in the run."""
        r = rng(self.seed, 2)
        scene_decks = self._decks(r)
        if self.p['size_per'] == 'call':
            size_sets = [[s] * self.fpc for s in dict.fromkeys(self.sizes)]
        else:
            size_sets = [list(self.sizes)]
        if self.p['persons_per'] == 'call':
            count_sets = [[c] for c in self.counts]
        else:
            lo, hi = self.counts[0], self.counts[-1]
            count_sets = []
            for total in range(lo * self.fpc, hi * self.fpc + 1):
                base, extra = divmod(total - lo * self.fpc, hi - lo or 1)
                per = [hi] * base + [lo] * (self.fpc - base)
                if base < self.fpc:
                    per[base] += extra
                count_sets.append(per)
        return [self._call(r, -1, sizes, counts, scene_decks)
                for sizes in size_sets for counts in count_sets]


def settings(params: dict) -> dict:
    """The predictor settings a mix fixes (the stream's keyframe rule)."""
    return {'camcalib_every': int(params.get('camcalib_every', 1)),
            'cut_threshold': float(params.get('cut_threshold', 0.5))}


class TrainBatches:
    """A pool of ``pool`` distinct seeded training batches of ``batch``
    rows in SPEC's batch layout (``spec_tpu_torch.train.steps.
    SPEC_BATCH_KEYS``), held in pinned host memory; step k trains on
    batch k mod pool. Parameters: ``img_res``; ``frame_hw``, the frames
    the crops were cut from; ``focal_px`` and ``cam_angle_rad`` (pitch
    and roll), the ground-truth cameras; ``box_scale`` (box side / 200);
    ``pose_aa_std``, ``betas_std``, ``joints3d_std_m``, the ground-truth
    bodies; ``has_pose_3d``, the share of rows with 3D joints. Images
    are crops of seeded scenes, ImageNet-normalized."""

    MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, params: dict, seed: int):
        import torch

        self.p = params
        r = rng(seed, 0)
        self.pool = [{k: torch.from_numpy(v).pin_memory()
                      if torch.cuda.is_available() else torch.from_numpy(v)
                      for k, v in self._batch(r).items()}
                     for _ in range(int(params['pool']))]

    def _batch(self, r) -> dict:
        p, B, res = self.p, int(self.p['batch']), int(self.p['img_res'])
        H, W = p['frame_hw']
        img = np.stack([scene(r, res, res, 1)[0] for _ in range(B)])
        img = ((img / np.float32(255.0) - self.MEAN) / self.STD).astype(
            np.float32)
        f = r.uniform(*p['focal_px'], B).astype(np.float32)
        pitch, roll = (r.uniform(-1, 1, (2, B)) * p['cam_angle_rad'])
        cp, sp, cr, sr = np.cos(pitch), np.sin(pitch), np.cos(roll), \
            np.sin(roll)
        o, z = np.ones(B), np.zeros(B)
        rx = np.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(B, 3, 3)
        rz = np.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(B, 3, 3)
        K = np.zeros((B, 3, 3), np.float32)
        K[:, 0, 0] = K[:, 1, 1] = f
        K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
        scale = r.uniform(*p['box_scale'], B).astype(np.float32)
        half = scale * 100.0
        center = np.stack([r.uniform(half, W - half), r.uniform(half, H - half)],
                          -1).astype(np.float32)
        kp = np.concatenate([center[:, None] + r.normal(
            0, 1, (B, 49, 2)) * half[:, None, None] / 2,
            np.ones((B, 49, 1))], -1)
        j3d = np.concatenate([r.normal(0, p['joints3d_std_m'], (B, 24, 3)),
                              np.ones((B, 24, 1))], -1)
        return {
            'img': img,
            'pose': r.normal(0, p['pose_aa_std'], (B, 72)).astype(np.float32),
            'betas': r.normal(0, p['betas_std'], (B, 10)).astype(np.float32),
            'pose_conf': np.ones((B, 24), np.float32),
            'pose_3d': j3d.astype(np.float32),
            'keypoints_orig': kp.astype(np.float32),
            'has_smpl': np.ones(B, np.float32),
            'has_pose_3d': (r.uniform(0, 1, B) < p['has_pose_3d']).astype(
                np.float32),
            'orig_shape': np.tile(np.array([[H, W]], np.float32), (B, 1)),
            'scale': scale,
            'center': center,
            'cam_rotmat': (rx @ rz).astype(np.float32),
            'cam_intrinsics': K,
        }
