"""Where an entry point puts its tensors, and what card that is.

Every entry point of the port takes `device=None` and resolves it here:
None means the CUDA device.  Nothing carries on on the CPU by itself; where
there is no card, torch's own error surfaces at the first allocation.  The
CPU (the tests, a debugger) is asked for by name.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """None -> torch.device("cuda"); anything else as torch reads it."""
    return torch.device("cuda") if device is None else torch.device(device)


def card_line() -> str:
    """`name, power limit` of the first card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
