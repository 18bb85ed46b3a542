"""BENCHMARK.json keeps to its contract, everything is found by name (a
new configuration, traffic mix or metric needs only new files), the run
loads neither JAX nor the JAX package (top-level names compared whole),
and a run without a card, or without the program, prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run, traffic
from benchmark.run import HERE

ROOT = HERE.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _bench():
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['benchmark'] and 1 <= b['run_seconds'] <= 51
    cells = {w['name'] for w in b['workloads']}
    e2e = {m['name'] for m in b['end_to_end']}
    assert 'setup_s' in e2e
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['file'].startswith('benchmark/')
        assert (ROOT / c['file']).is_file()
        assert any(w['config'] == c['name'] for w in b['workloads'])
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and w['chips'] in (1, 4)
        assert len(w['why']) <= 200
        assert (HERE / 'traffic' / f'{w["traffic"]}.json').is_file()
        assert (HERE / 'limits' / f'{w["name"]}.json').is_file()
        reported = [m for m in b['end_to_end'] + b['per_layer']
                    if w['name'] in m.get('workloads', [w['name']])]
        assert any(m['name'] == 'setup_s' for m in reported)
        assert len({m['name'] for m in reported
                    if m in b['end_to_end']}) >= 2
        assert any(m in b['per_layer'] for m in reported)
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in b['per_layer']:
        assert m['moves'] in e2e and 'bound' not in m
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', [])) <= cells
        assert (HERE / 'metrics' / f'{m["name"]}.py').is_file()
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries only: the harness loads them without an edit."""
    home = tmp_path / 'benchmark'
    shutil.copytree(HERE, home, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    b = _bench()
    cfg = json.loads((HERE / 'configs' / 'spec-resnet50.json').read_text())
    cfg['hmr']['backbone'] = 'resnet101'
    (home / 'configs' / 'spec-resnet101.json').write_text(json.dumps(cfg))
    mix = traffic.load('crowd_video')
    mix['persons'] = [1, 2]
    (home / 'traffic' / 'sparse_video.json').write_text(json.dumps(mix))
    (home / 'metrics' / 'calls_per_s.py').write_text(
        'def read(rec):\n    return len(rec.calls) / rec.window_s\n')
    (home / 'limits' / 'r101-sparse-video.json').write_text('{"pose": 1}')
    b['configs'].append({'name': 'spec-resnet101', 'source': 'x',
                         'file': 'benchmark/configs/spec-resnet101.json',
                         'reduced': [], 'why': 'x'})
    b['workloads'].append({'name': 'r101-sparse-video',
                           'config': 'spec-resnet101',
                           'traffic': 'sparse_video', 'chips': 1,
                           'why': 'x'})
    b['per_layer'].append({'name': 'calls_per_s', 'unit': 'calls/s',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'Entry and host glue',
                           'moves': 'persons_per_s'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))
    cell = run.Cell.load('r101-sparse-video', root=tmp_path)
    assert cell.config['hmr']['backbone'] == 'resnet101'
    assert cell.mix['persons'] == [1, 2] and cell.limits == {'pose': 1}
    assert [m['name'] for m in cell.per_layer] == ['calls_per_s']
    rec = run.Window(None, window_s=2.0, calls=[1, 2, 3])
    got = run.read_metrics(cell.per_layer, rec, cell.home)
    assert got == {'calls_per_s': {'value': 1.5, 'unit': 'calls/s'}}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'spec_tpu_torch_like', sys)
    assert 'spec_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'spec_tpu.core', sys)
    assert 'spec_tpu' in run.forbidden_modules()


def test_the_harness_and_the_program_load_no_jax():
    code = ('import sys; import benchmark.run, benchmark.calibrate, '
            'benchmark.drivers.predict, benchmark.reference.predict, '
            'benchmark.profile; import spec_tpu_torch.serving; '
            'from benchmark.run import forbidden_modules; '
            'print(forbidden_modules())')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, 'PYTHONPATH': str(ROOT)})
    assert out.stdout.strip() == '[]'


def _cli(cwd, env_path):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    if env_path:
        env['PYTHONPATH'] = env_path
    return subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         'r50-crowd-video', '--seed', '3', '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip('a card is present: the run would measure')
    out = _cli(ROOT, str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / 'benchmark')
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    out = _cli(tmp_path, '')
    assert out.returncode != 0 and out.stdout.strip() == ''
