"""The benchmark of spec_tpu_torch: ``python3 -m benchmark.run --workload
NAME --seed N --seconds S --trace 0|1`` from the root of a checkout.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``benchmark/traffic/<mix>.json``,
read by the one generator ``benchmark/traffic.py``), the driver of the
mix's entry point (``benchmark/drivers/<entry>.py``), one reader per
metric (``benchmark/metrics/<metric>.py``) and the cell's limits
(``benchmark/limits/<workload>.json``).

A run: set-up (seeded weights and inputs, the program built and warmed
up on every shape the mix can produce: ``setup_s``), a window of
``--seconds`` in which one caller runs the mix's calls back to back,
then the check: the plain reference (``benchmark/reference/``) on a
sample of the window's calls drawn from the seed, the largest call among
them, each gap printed beside its limit. ``--trace 1`` profiles a slice
of the window and reports the per-layer metrics instead of the
end-to-end ones. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# Top-level module names that no run may load (the JAX package and JAX).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'spec_tpu')
SAMPLE_CALLS = 6            # calls drawn for the check, besides the largest
SLICE_AFTER_S = 1.0         # the profiled slice starts this far in
SLICE_CALLS = 8             # calls profiled in a traced run


def _fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ.setdefault(var, str(ROOT / 'build' / 'cache' / sub))
    os.environ.setdefault('USE_FLAX', '0')


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with what it names, loaded."""
    name: str
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    limits: dict
    home: Path = HERE           # the benchmark's folder

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> 'Cell':
        bench = json.loads((root / 'BENCHMARK.json').read_text())
        cell = next((w for w in bench['workloads'] if w['name'] == name),
                    None)
        if cell is None:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
        conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
        from benchmark import traffic

        def reported(metrics):
            return [m for m in metrics
                    if name in m.get('workloads', [name])]

        home = root / 'benchmark'
        limits = json.loads((home / 'limits' / f'{name}.json').read_text())
        return cls(name, json.loads((root / conf['file']).read_text()),
                   traffic.load(cell['traffic'], home / 'traffic'),
                   reported(bench['end_to_end']),
                   reported(bench['per_layer']), limits, home)


@dataclasses.dataclass
class Window:
    """What one run recorded, for the metric readers."""
    driver: object
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    units: int = 0
    calls: list = dataclasses.field(default_factory=list)   # every call
    profile: dict | None = None
    slice_calls: list = dataclasses.field(default_factory=list)
    slice_s: float = 0.0
    slice_k1_launches: int = 0


def entry_module(cell: Cell):
    """The driver module of the cell's entry point."""
    return load_module(cell.home / 'drivers' / f'{cell.mix["entry"]}.py',
                       f'benchmark_driver_{cell.mix["entry"]}')


def driver_for(cell: Cell, seed: int, device):
    """The cell's driver; the program reads the assets it writes from
    ``build/bench_data`` in the checkout."""
    return entry_module(cell).Driver(cell.config, cell.mix, seed, device,
                                     ROOT / 'build' / 'bench_data')


def _k1_launches() -> int:
    from spec_tpu_torch.ops import lbs

    return lbs.LAUNCHES


class Sample:
    """A uniform sample of the window's calls drawn from the seed
    (reservoir), and the largest call, with their outputs."""

    def __init__(self, seed: int, size: int = SAMPLE_CALLS):
        import numpy as np

        self.rng = np.random.default_rng([seed % 2 ** 64, 9])
        self.size, self.seen = size, 0
        self.kept: list = []
        self.largest = None

    def offer(self, call, output) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((call, output))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.kept[j] = (call, output)
        if self.largest is None or call.persons > self.largest[0].persons:
            self.largest = (call, output)

    def items(self) -> list:
        out = list(self.kept)
        if self.largest is not None and all(
                self.largest[0] is not c for c, _ in out):
            out.append(self.largest)
        return out


def run_window(driver, seconds: float, trace: bool, sample: Sample,
               rec: Window, errors: list) -> tuple[int, int]:
    """One caller, back to back, for ``seconds``. Returns the calls that
    raised and those that returned too few or too many units."""
    import torch

    raised, short, prof, t_slice, profiled = 0, 0, None, 0.0, 0
    k1_before = 0
    cuda = torch.device(driver.device).type == 'cuda'
    calls = driver.calls()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        call = next(calls)
        if (trace and cuda and prof is None and profiled == 0
                and time.perf_counter() - t0 >= SLICE_AFTER_S):
            from benchmark import profile

            torch.cuda.synchronize()
            k1_before = _k1_launches()
            t_slice = time.perf_counter()
            prof = profile.start()
        c0 = time.perf_counter()
        try:
            units, out = driver.run(call)
        except Exception:           # a failed call is counted and shown
            raised += 1
            if len(errors) < 3:
                errors.append(traceback.format_exc())
            continue
        c1 = time.perf_counter()
        rec.latencies_s.append(c1 - c0)
        rec.units += units
        rec.calls.append(call)
        if units != driver.expected(call):
            short += 1
        sample.offer(call, out)
        if prof is not None:
            rec.slice_calls.append(call)
            profiled += 1
            if profiled == SLICE_CALLS:
                torch.cuda.synchronize()
                rec.slice_s = time.perf_counter() - t_slice
                rec.slice_k1_launches = _k1_launches() - k1_before
                prof.stop()
                rec.profile = prof
                prof = None
    rec.window_s = time.perf_counter() - t0
    if prof is not None:            # the window closed inside the slice
        torch.cuda.synchronize()
        rec.slice_s = time.perf_counter() - t_slice
        rec.slice_k1_launches = _k1_launches() - k1_before
        prof.stop()
        rec.profile = prof
    return raised, short


def read_metrics(specs: list, rec: Window, home: Path = HERE) -> dict:
    """Each metric by its reader, ``<home>/metrics/<name>.py``; a reader
    that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in specs:
        mod = load_module(home / 'metrics' / f'{m["name"]}.py',
                          'benchmark_metric_' + m['name'].replace('.', '_'))
        value = mod.read(rec)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def checks(gaps: dict, limits: dict) -> dict:
    """Each compared number beside its limit; a number with no limit, or
    not finite, fails."""
    return {k: {'value': v, 'limit': limits.get(k)} for k, v in gaps.items()}


def passed(checked: dict) -> bool:
    return all(c['limit'] is not None and c['value'] <= c['limit']
               for c in checked.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device='cuda') -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    t_setup = time.perf_counter()
    driver = driver_for(cell, seed, device)
    driver.setup()
    rec = Window(driver, setup_s=time.perf_counter() - t_setup)
    sample, errors = Sample(seed), []
    raised, short = run_window(driver, seconds, trace, sample, rec, errors)
    for e in errors:
        print(e, file=sys.stderr)
    dev = torch.device(device)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    breakdown = None
    if rec.profile is not None:
        from benchmark import profile

        rec.profile = profile.read(rec.profile)
        breakdown = profile.breakdown(rec.profile)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           rec, cell.home)
    items = sample.items()
    driver.release()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    gaps = entry_module(cell).compare(driver.observed(items),
                                      driver.reference(items))
    checked = checks(gaps, cell.limits)
    failed = raised + short
    result = {
        'correct': bool(items) and failed == 0 and passed(checked),
        'attempted': len(rec.calls) + raised,
        'failed': failed,
        'metrics': metrics,
        'device': device_info(dev, peak, rec),
    }
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checked
    return result


def device_info(dev, peak: int, rec: Window) -> dict:
    import torch

    if dev.type != 'cuda':
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': peak}
    else:
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
                'count': 1, 'memory_peak_bytes': peak}
    if rec.profile is not None:
        info['busy_s'] = rec.profile['busy_s']
        info['window_s'] = rec.slice_s
    return info


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (compared whole) is one of
    FORBIDDEN."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    if importlib.util.find_spec('spec_tpu_torch') is None:
        print('the program (spec_tpu_torch) is not in this checkout',
              file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print('no CUDA device: the benchmark runs on a GPU only',
              file=sys.stderr)
        return 2
    cell = Cell.load(args.workload)
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f'forbidden modules loaded: {bad}', file=sys.stderr)
        return 3
    for k, c in result['checks'].items():
        print(f'check {k}: {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
