"""Headline benchmark: video embedding throughput, videos/s on one card.

    python -m cross_modal_video_engine_tpu_torch.bench.headline

The JAX package's bench.py program: the CLIP ViT-B/32 vision tower in bf16
over batches of 128 videos of 8 x 224^2 frames (bf16, on the device), 20
steps a run, timed by CUDA events.  Two arms over the same weights, in
turns (plain, kernel, kernel, plain): the kernel arm runs the fused
sublayers (the hand-written kernels), the plain arm the same model in
plain torch ops.  Prints one JSON line: `metric`, `value` (kernel arm,
videos/s), `unit`, `vs_baseline` (kernel arm over plain arm), `plain`,
the runs, the card's name and power limit, the torch and CUDA versions.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from ..models.clip import CLIPConfig
from ..utils.device import resolve_device
from .common import (clip_arms, emit, flagship_config, per, time_arms,
                     where)

METRIC = "video_embed_throughput_vitb32_bf16_8f224"


def bench_headline(batch: int = 128, frames: int = 8, steps: int = 20,
                   device=None, cfg: Optional[CLIPConfig] = None) -> dict:
    device = resolve_device(device)
    cfg = cfg or flagship_config()
    kernel, plain = clip_arms(cfg, device)
    res = cfg.image_resolution
    gen = torch.Generator(device=device).manual_seed(0)
    clip = torch.randn((batch, frames, res, res, 3), generator=gen,
                       device=device).to(cfg.torch_dtype())

    def embed(model):
        with torch.no_grad():
            return model.encode_video(clip)[0]

    value, base, rates = time_arms(embed, kernel, plain, batch, steps)
    if not bool(torch.isfinite(embed(kernel)).all()):
        raise RuntimeError("the kernel arm's embeddings are not finite")
    return emit({"metric": METRIC, "value": value,
                 "unit": per("videos/sec", device),
                 "vs_baseline": value / base, "plain": base,
                 "runs": rates, "batch": batch, "steps": steps,
                 **where(device)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device")
    args = ap.parse_args(argv)
    bench_headline(batch=args.batch, steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
