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
``ops/bottleneck.py`` and ``ops/projection.py``. The command-line entry
points ``python -m spec_tpu_torch.cli.serve`` (the HTTP server),
``camcalib_demo`` and ``spec_demo`` (folder, video and webcam) run on
the card unless ``--device cpu`` is given. :mod:`spec_tpu_torch.export`
writes and loads ``.specx`` deployment artifacts (``torch.export``
programs; ``cli.export_model``, ``cli.serve --exported``), and
``datagen/`` generates the offline datasets.

The package imports ``torch`` and ``numpy`` only and nothing of
``spec_tpu``: the joint and normalization tables it needs are its own
copy in ``core/constants.py``. scipy (a chumpy SMPL pickle, the SORT
tracker, a written SMPL pickle), PIL, cv2, joblib, PyYAML, matplotlib
and requests are imported only inside the functions that need them.
CUDA kernels under ``csrc/`` are built with ``nvcc`` on first use; the
bottleneck kernel's bf16 variant runs its products on the tensor cores.
"""

from __future__ import annotations

__version__ = '0.1.0'
