"""What the bench entry points share: the two arms over one seeded state
dict, their timing in turns, the card's description and the JSON rows."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.clip import (CLIPConfig, CLIPModel, flagship_config,
                           seeded_state_dict)
from ..utils.device import card_line
from ..utils.profiling import device_time


def clip_arms(cfg: CLIPConfig, device, seed: int = 0, *,
              kernel_flags: Optional[dict] = None,
              plain_flags: Optional[dict] = None
              ) -> Tuple[CLIPModel, CLIPModel]:
    """Two models over one seeded state dict: the kernel arm (fused_attn
    and fused_mlp on, unless kernel_flags says otherwise) and the arm it is
    measured against (plain torch ops, unless plain_flags says
    otherwise)."""
    sd = seeded_state_dict(cfg, seed)
    arms = []
    for flags in (kernel_flags or dict(fused_attn=True, fused_mlp=True),
                  plain_flags or dict(fused_attn=False, fused_mlp=False)):
        model = CLIPModel(dataclasses.replace(cfg, **flags), device=device)
        model.load_state_dict(sd)
        arms.append(model.eval().requires_grad_(False))
    return arms[0], arms[1]


def time_arms(run, kernel: CLIPModel, plain: CLIPModel, count: int,
              steps: int) -> Tuple[float, float, dict]:
    """`count` items per second of run(model) for both arms, timed in turns
    (plain, kernel, kernel, plain): the kernel arm's mean, the plain arm's
    mean, and the runs."""
    rates = {"plain": [], "kernel": []}
    for arm in ("plain", "kernel", "kernel", "plain"):
        seconds = device_time(run, kernel if arm == "kernel" else plain,
                              steps=steps)
        rates[arm].append(count / seconds)
    return (float(np.mean(rates["kernel"])), float(np.mean(rates["plain"])),
            rates)


def where(device: torch.device) -> dict:
    """What a row says about where it ran: on a card its name and power
    limit and the torch and CUDA versions; on the CPU, that it was the
    CPU (such a row is no device measurement)."""
    info = {"device": "cpu", "power_limit": None,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        name, _, limit = card_line().partition(",")
        info.update(device=name.strip(), power_limit=limit.strip())
    return info


def per(unit: str, device: torch.device, card: str = "chip") -> str:
    """`unit/chip` for a row measured on a card, `unit/cpu` otherwise: a
    CPU run never carries a device metric's name."""
    return f"{unit}/{card if device.type == 'cuda' else 'cpu'}"


def emit(row: dict, out: Optional[list] = None) -> dict:
    """Print the row as one JSON line (and keep it in `out`)."""
    print(json.dumps(row), flush=True)
    if out is not None:
        out.append(row)
    return row
