"""spec_tpu_torch: the PyTorch + CUDA port of spec_tpu.

The JAX package ``spec_tpu`` stays the reference; this package mirrors
its module layout and names so each piece has an obvious counterpart,
and is held to it by the ``tests/test_torch_*.py`` parity tests.

Ported today: the two-stage inference slice behind
:class:`spec_tpu_torch.serving.SpecPredictor` (CamCalib ResNet, bin
decode, camera assembly, on-device SPIN crop, HMR ResNet + iterative
head, SMPL with the fused LBS CUDA kernel, full-image projection), and
the e2e device pipeline :func:`spec_tpu_torch.pipeline.build_pipeline`
with either the CamCalib module or the folded-BN
:class:`~spec_tpu_torch.models.backbones.fused_resnet.FusedResNet` trunk
(bottleneck-chain CUDA kernel) as stage 1. All three Pallas kernels of
the JAX package have CUDA counterparts: ``ops/lbs.py``,
``ops/bottleneck.py`` and ``ops/projection.py``.

The package imports ``torch`` and ``numpy`` only (plus ``scipy`` when a
chumpy SMPL pickle is read); from ``spec_tpu`` it uses only the numpy
tables of ``spec_tpu.core.constants``. CUDA kernels under ``csrc/`` are
built with ``nvcc`` on first use.
"""

from __future__ import annotations

__version__ = '0.1.0'
