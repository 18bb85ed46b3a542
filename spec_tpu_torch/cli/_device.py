"""The ``--device`` rule of the port's command-line entry points: they
run on the card unless the caller asks for the CPU, and never fall back
to the CPU on their own."""

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
