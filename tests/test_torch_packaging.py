"""The port ships its native sources: every ``csrc/`` source that the
build helpers compile at first use (``ops/cuda_build.load_library`` for
``csrc/<name>.cu``, ``load_host_library`` for ``csrc/<name>.cpp``) is
matched by a package-data glob of ``spec_tpu_torch`` in pyproject.toml,
so an installed package can build its kernels and host libraries."""

import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'spec_tpu_torch'


def _package_globs():
    with open(ROOT / 'pyproject.toml', 'rb') as f:
        conf = tomllib.load(f)
    return conf['tool']['setuptools']['package-data']['spec_tpu_torch']


def _named_sources():
    """(suffix, name) of every library the package's code loads."""
    calls = {'load_library': '.cu', 'load_host_library': '.cpp'}
    found = set()
    for py in PKG.rglob('*.py'):
        for fn, name in re.findall(
                r"\b(load_library|load_host_library)\('(\w+)'\)",
                py.read_text()):
            found.add(f'csrc/{name}{calls[fn]}')
    return sorted(found)


@pytest.mark.parametrize('source', _named_sources())
def test_named_source_exists_and_ships(source):
    assert (PKG / source).is_file(), source
    assert any(fnmatch.fnmatch(source, g) for g in _package_globs()), (
        source, _package_globs())


def test_every_csrc_source_ships():
    """Also the sources no loader names yet: the whole csrc/ tree."""
    sources = [p.relative_to(PKG).as_posix()
               for p in (PKG / 'csrc').iterdir()
               if p.suffix in ('.cu', '.cpp', '.cuh', '.h')]
    assert {'csrc/lbs.cu', 'csrc/raster.cpp', 'csrc/jpegroi.cpp'} <= set(
        sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in _package_globs()), src
