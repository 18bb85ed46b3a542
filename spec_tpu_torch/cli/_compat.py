"""Reference CLI flag-surface compatibility helpers (after
``spec_tpu/cli/_compat.py``).

The reference's eval script exposes a group of MPI-cluster submission
flags (``--cluster --bid --memory --num_cpus --gpu_min_mem --gpu_arch``)
whose implementation is stubbed out in the reference itself
(``spec/config.py:272-286``), plus ``--disable_comet`` for a logger that
is imported but never registered (``scripts/spec_train.py:17,64-73``).
Scripts written against the reference CLIs pass these; accept them as
documented no-ops so such invocations run unchanged. The trainer's
``--num_gpus`` is one more no-op (``num_gpus=True``; ``camcalib_train``).
"""

from __future__ import annotations

import argparse


def add_cluster_flags(parser: argparse.ArgumentParser,
                      num_gpus: bool = False) -> None:
    g = parser.add_argument_group(
        'reference compatibility (accepted no-ops)')
    g.add_argument('--cluster', action='store_true',
                   help='cluster submission — stubbed in the reference '
                        '(spec/config.py:272-286); no-op here')
    g.add_argument('--bid', type=int, default=5, help='no-op (cluster)')
    g.add_argument('--memory', type=int, default=64000,
                   help='no-op (cluster)')
    g.add_argument('--num_cpus', type=int, default=8,
                   help='no-op (cluster)')
    if num_gpus:
        g.add_argument('--num_gpus', type=int, default=1,
                       help='no-op (cluster)')
    g.add_argument('--gpu_min_mem', type=int, default=10000,
                   help='no-op (cluster)')
    g.add_argument('--gpu_arch', default=None, nargs='*',
                   help='no-op (cluster)')
    g.add_argument('--disable_comet', action='store_true',
                   help='no-op (comet was never wired in the reference)')
