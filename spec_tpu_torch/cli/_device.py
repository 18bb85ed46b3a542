"""The ``--device`` rule of the port's command-line entry points: they
run on the card unless the caller asks for the CPU, and never fall back
to the CPU on their own. The training and eval entry points also take
the multi-process flags (:func:`add_process_flags`)."""

from __future__ import annotations

import argparse


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device: 'cuda' (default; an NVIDIA "
                             "GPU) or 'cpu', which must be asked for")


def resolve_device(device: str, prog: str):
    """-> the torch device, or ``SystemExit`` with a message when a CUDA
    device is asked for (the default) and there is none."""
    import torch

    dev = torch.device(device)
    if dev.type not in ('cuda', 'cpu'):
        raise SystemExit(f'{prog}: unsupported device {device!r}; use '
                         "'cuda' or 'cpu'")
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(
            f'{prog}: no CUDA card (torch.cuda.is_available() is False); '
            'this entry point runs on an NVIDIA GPU and never falls back '
            'to the CPU: pass --device cpu for a CPU run')
    return dev


def add_process_flags(parser: argparse.ArgumentParser) -> None:
    """``--coordinator_address``, ``--num_processes``, ``--process_id``
    (the JAX CLIs' multi-host flags) and ``--dist_backend``."""
    parser.add_argument('--coordinator_address', type=str, default='',
                        help='multi-process: host:port of rank 0 '
                             '(torch.distributed tcp://); without it a '
                             "launcher's RANK/WORLD_SIZE/MASTER_ADDR/"
                             'MASTER_PORT are read (torchrun)')
    parser.add_argument('--num_processes', type=int, default=None,
                        help='multi-process: the world size')
    parser.add_argument('--process_id', type=int, default=None,
                        help="multi-process: this process's rank")
    parser.add_argument('--dist_backend', type=str, default=None,
                        choices=['nccl', 'gloo'],
                        help='process group backend (default: nccl on a '
                             'card, gloo on the CPU; gloo for ranks that '
                             'share one card)')


def join_processes(args, device):
    """Join the process group the flags (or a launcher's environment)
    name, if any, and return the device this rank drives
    (``parallel.local_device``)."""
    from spec_tpu_torch import parallel as par

    par.initialize_multihost(args.coordinator_address or None,
                             args.num_processes, args.process_id,
                             backend=args.dist_backend, device=device)
    return par.local_device(device)
