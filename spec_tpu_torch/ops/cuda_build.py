"""Build and load the package's native libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` into a shared library loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. The host C++ sources ``csrc/<name>.cpp`` (the
mesh rasterizer, the JPEG region-of-interest decoder) are compiled with
``g++`` the same way, one library per source, with the JAX package's
flags (``spec_tpu/native/__init__.py``). Libraries go to
``build/spec_tpu_torch/`` at the root of the checkout, named by a hash
of the source and the flags, written under a temporary name and renamed
into place (concurrent builders never see a half-written file), and are
built at first use (never at import). A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'spec_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
GXX_FLAGS = ('-O3', '-march=native', '-fopenmp', '-shared', '-fPIC')
# Libraries each host source links: only the JPEG decoder needs libjpeg,
# so the rasterizer builds on a machine without it.
HOST_LIBS = {'raster': (), 'jpegroi': ('-ljpeg',)}


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


def _build(src: Path, lib_stem: str, flags, command) -> tuple[Path, str,
                                                              float]:
    """Compile ``src`` unless a build of the same source and flags
    exists; ``command(tmp)`` is the compiler's argument list writing to
    ``tmp``. Returns (library path, compiler log, build seconds; 0 when
    the library was already built)."""
    h = hashlib.sha256(src.read_bytes())
    h.update(repr(tuple(flags)).encode())
    lib = BUILD_DIR / f'lib{lib_stem}-{h.hexdigest()[:16]}.so'
    if lib.exists():
        return lib, '', 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'{Path(cmd[0]).name} failed to build {src} '
                           f'(exit {proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr, seconds


@functools.cache
def build_library(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless a build of the same source
    exists. Returns (library path, compiler log, build seconds; 0 when
    the library was already built)."""
    src = CSRC / f'{name}.cu'
    return _build(src, name, NVCC_FLAGS,
                  lambda tmp: [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                               str(src)])


@functools.cache
def build_host_library(name: str) -> tuple[Path, str, float]:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` and
    ``GXX_FLAGS``, linking ``HOST_LIBS[name]``, unless a build of the
    same source and flags exists. Returns (library path, compiler log,
    build seconds; 0 when the library was already built). A machine
    without ``g++`` or the linked library raises."""
    src = CSRC / f'{name}.cpp'
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError(f'g++ not found on PATH: csrc/{name}.cpp builds '
                           'only where a C++ compiler is installed')
    libs = HOST_LIBS[name]
    return _build(src, f'host_{name}', GXX_FLAGS + libs,
                  lambda tmp: [gxx, *GXX_FLAGS, '-o', str(tmp), str(src),
                               *libs])


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cpp``."""
    path, _, _ = build_host_library(name)
    return ctypes.CDLL(str(path))


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
