"""The benchmark of the PyTorch/CUDA port (``spec_tpu_torch``): run one
cell of ``BENCHMARK.json`` with ``python3 -m benchmark.run`` from the root
of a checkout on a machine with a CUDA card (``benchmark/run.py``); the
limits of its correctness check come from ``python3 -m
benchmark.calibrate``. Nothing here imports JAX or the JAX package."""
