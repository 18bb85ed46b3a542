"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` into a shared library loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. Libraries go to ``build/spec_tpu_torch/`` at
the root of the checkout, named by a hash of the source, and are built
at first use (never at import). A failed build raises.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'spec_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found on PATH or under CUDA_HOME; the '
                       'CUDA kernels build only where the CUDA toolkit is '
                       'installed')


@functools.cache
def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless a build of the same source
    exists. Returns (library path, compiler log, build seconds; 0 when
    the library was already built)."""
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f'lib{name}-{digest}.so'
    if lib.exists():
        return lib, '', 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed to build {src} '
                           f'(exit {proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr, seconds


def build_libraries(names) -> dict:
    """Build several sources at once, one ``nvcc`` process each, all
    started together. Returns {name: build_library(name)}; the first
    failed build raises."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as ex:
        return dict(zip(names, ex.map(build_library, names)))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    path, _, _ = build_library(name)
    return ctypes.CDLL(str(path))
