"""Ratio-weighted mixture over CamDatasets (port of
``spec_tpu/data/mixed_dataset.py``): names and ratios parsed from
``'ds1_ds2_r1_r2'`` strings; in-the-wild ratios re-weighted by member
size; a sample draws a member by cumulative ratio and indexes it modulo
its length; the length is the longest member's."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def parse_datasets_ratios(spec: str):
    """``'ds-a_ds-b_0.3_0.7' -> (['ds-a', 'ds-b'], [0.3, 0.7])``."""
    parts = spec.split('_')
    half = len(parts) // 2
    names = parts[:half]
    ratios = [float(r) for r in parts[half:]]
    assert len(names) == len(ratios), f'bad datasets_and_ratios: {spec}'
    return names, ratios


class MixedCamDataset:
    """Samples from member datasets with fixed probabilities."""

    def __init__(self, datasets: Sequence, ratios: Sequence[float],
                 itw_names: Sequence[str] = ('mpii', 'coco', 'lspet'),
                 seed: int = 0):
        assert len(datasets) == len(ratios)
        self.datasets = list(datasets)
        lengths = np.array([len(d) for d in datasets], np.float64)
        ratios = np.array(ratios, np.float64)
        # In-the-wild members: ratio scaled by relative size, so a small
        # one is not oversampled.
        names = [getattr(d, 'dataset', '') for d in datasets]
        itw_idx = [i for i, nm in enumerate(names) if nm in itw_names]
        if itw_idx:
            itw_total = lengths[itw_idx].sum()
            for i in itw_idx:
                ratios[i] = ratios[i] * lengths[i] / itw_total
        self.partition = np.cumsum(ratios / ratios.sum())
        self.lengths = lengths.astype(np.int64)
        self.length = int(lengths.max())
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        p = self.rng.rand()
        for i in range(len(self.datasets)):
            if p <= self.partition[i]:
                return self.datasets[i][index % self.lengths[i]]
        return self.datasets[-1][index % self.lengths[-1]]
