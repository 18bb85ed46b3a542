"""The readings a cell's limits are set from: ``python3 -m
benchmark.calibrate --workload NAME --seeds N [N ...] --seconds S``.

For each seed: the run's set-up, a short window at the cell's own load,
and the run's sample of calls (as many, and the largest among them);
then the program's gaps to the plain reference (the lower readings),
the control's (the reference itself in the program's place, computed
with TF32, the precision next below the configuration's float32 with
TF32 off) and those of the faults the driver plants in the reference.
One JSON line per seed, then the largest lower reading and the smallest
control and fault readings of each number. The benchmark's runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from benchmark import run


def readings(cell: run.Cell, seed: int, seconds: float, device='cuda'):
    """The program's gaps, the control's, each fault's (as the driver
    plants them in the reference) and the calls of the window, for one
    seed."""
    import torch

    driver = run.driver_for(cell, seed, device)
    driver.setup()
    rec = run.Window(driver)
    sample, errors = run.Sample(seed), []
    raised, short = run.run_window(driver, seconds, False, sample, rec,
                                   errors)
    if raised or short:
        raise RuntimeError(f'seed {seed}: {raised} calls raised, {short} '
                           f'returned the wrong count\n' + ''.join(errors))
    items = sample.items()
    driver.release()
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    compare = run.entry_module(cell).compare
    ref = driver.reference(items)
    program = compare(driver.observed(items), ref)
    control = compare(driver.reference(items, tf32=True), ref)
    faults = {k: compare(v, ref) for k, v in driver.faults(items).items()}
    return program, control, faults, len(rec.calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    run._fixed_caches()
    cell = run.Cell.load(args.workload)
    lower, control, faults = {}, {}, {}
    for seed in args.seeds:
        prog, ctrl, flt, n_calls = readings(cell, seed, args.seconds)
        print(json.dumps({'seed': seed, 'calls': n_calls, 'program': prog,
                          'control': ctrl, 'faults': flt}), flush=True)
        for k in prog:
            lower[k] = max(lower.get(k, 0.0), prog[k])
            control[k] = min(control.get(k, float('inf')), ctrl[k])
            for name, f in flt.items():
                low = faults.setdefault(name, {})
                low[k] = min(low.get(k, float('inf')), f[k])
    print(json.dumps({'workload': args.workload, 'seeds': len(args.seeds),
                      'lower': lower, 'control': control,
                      'faults': faults}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
