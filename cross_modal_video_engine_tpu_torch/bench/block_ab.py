"""Whole-block kernel against the two-kernel chain, and fused_mlp on the
compact program.

    python -m cross_modal_video_engine_tpu_torch.bench.block_ab [--repeats 5]
        [--skip-model] [--skip-op] [--out FILE]

The JAX package's bench_block_ab.py, both halves, at the headline
geometry (ViT-B/32 vision tower: 1024 sequences x L=50 x D=768, 12 heads,
bf16, compact flat rows):

1. op level: a 12-layer stack through `fused_attention_sublayer_compact` +
   `fused_mlp_sublayer` (two wrappers a layer) against the same stack
   through `fused_block_sublayer_compact` (one launch a layer).  Rows
   `stack12_two_kernels` and `stack12_whole_block` (ms, and
   `speedup_vs_two_kernels`).  A kernel that fails to launch fails the
   run.
2. model level: the full embed program with fused_attn + fused_mlp against
   fused_attn only, interleaved repeats, and the verdict row.

One JSON line per row.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.clip import CLIPConfig
from ..ops.attention_sublayer import (fused_attention_sublayer_compact,
                                      fused_block_sublayer_compact,
                                      fused_mlp_sublayer)
from ..utils.device import resolve_device
from ..utils.profiling import device_time
from .common import clip_arms, emit, flagship_config, where


def build_stack(nseq: int = 1024, seq_len: int = 50, width: int = 768,
                layers: int = 12, device=None,
                dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, List[Tuple[tuple, tuple]]]:
    """x and the per-layer (attention, MLP) parameters from
    np.random.default_rng(1), drawn in the JAX bench's order and scales
    and transposed to torch Linear layout."""
    device = resolve_device(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((nseq * seq_len, width)) * 0.1)
                         .astype(np.float32)).to(device, dtype)

    def w(shape, s=0.03, shift=0.0):
        a = (rng.standard_normal(shape) * s + shift).astype(np.float32)
        if a.ndim == 2:                       # (in, out) -> Linear (out, in)
            a = np.ascontiguousarray(a.T)
        return torch.from_numpy(a).to(device)

    d = width
    params = []
    for _ in range(layers):
        attn = (w((d,), 0.1, 1.0), w((d,), 0.1), w((d, d)), w((d,), 0.01),
                w((d, d)), w((d,), 0.01), w((d, d)), w((d,), 0.01),
                w((d, d)), w((d,), 0.01))
        mlp = (w((d,), 0.1, 1.0), w((d,), 0.1), w((d, 4 * d)),
               w((4 * d,), 0.01), w((4 * d, d)), w((d,), 0.01))
        # the kernels read the parameters in x.dtype: round them once here,
        # not in every call
        params.append((tuple(t.to(dtype) for t in attn),
                       tuple(t.to(dtype) for t in mlp)))
    return x, params


def stack_two(x, params, *, heads: int, seq_len: int) -> torch.Tensor:
    with torch.no_grad():
        for attn, mlp in params:
            x = fused_attention_sublayer_compact(x, *attn, heads=heads,
                                                 seq_len=seq_len)
            x = fused_mlp_sublayer(x, *mlp)
    return x


def stack_block(x, params, *, heads: int, seq_len: int) -> torch.Tensor:
    with torch.no_grad():
        for attn, mlp in params:
            x = fused_block_sublayer_compact(x, *attn, *mlp, heads=heads,
                                             seq_len=seq_len)
    return x


def bench_op_level(nseq: int = 1024, seq_len: int = 50, width: int = 768,
                   heads: int = 12, layers: int = 12, steps: int = 10,
                   device=None, out: Optional[list] = None) -> List[dict]:
    """The stack through both routes, in turns (two, block, block, two)."""
    device = resolve_device(device)
    x, params = build_stack(nseq, seq_len, width, layers, device)
    times = {"two": [], "block": []}
    for arm in ("two", "block", "block", "two"):
        fn = stack_two if arm == "two" else stack_block
        times[arm].append(device_time(
            lambda: fn(x, params, heads=heads, seq_len=seq_len),
            steps=steps, device=device) * 1e3)
    t2, tb = float(np.mean(times["two"])), float(np.mean(times["block"]))
    info = where(device)
    return [
        emit({"metric": f"stack{layers}_two_kernels", "value": t2,
              "unit": "ms", "vs_baseline": 1.0, "runs": times["two"],
              "rows": nseq * seq_len, **info}, out),
        emit({"metric": f"stack{layers}_whole_block", "value": tb,
              "unit": "ms", "speedup_vs_two_kernels": t2 / tb,
              "vs_baseline": t2 / tb, "runs": times["block"],
              "rows": nseq * seq_len, **info}, out)]


def bench_model_level(batch: int = 128, frames: int = 8, steps: int = 20,
                      repeats: int = 5, device=None,
                      cfg: Optional[CLIPConfig] = None,
                      out: Optional[list] = None) -> List[dict]:
    """fused_attn + fused_mlp against fused_attn only, the full embed
    program, interleaved repeats; medians and the verdict."""
    device = resolve_device(device)
    cfg = cfg or flagship_config()
    both, attn_only = clip_arms(
        cfg, device, plain_flags=dict(fused_attn=True, fused_mlp=False))
    arms = {"attn+mlp": both, "attn_only": attn_only}
    res = cfg.image_resolution
    gen = torch.Generator(device=device).manual_seed(0)
    clip = torch.randn((batch, frames, res, res, 3), generator=gen,
                       device=device).to(cfg.torch_dtype())

    def embed(model):
        with torch.no_grad():
            return model.encode_video(clip)[0]

    rates = {k: [] for k in arms}
    for _ in range(repeats):                    # interleaved: drift-fair
        for k, model in arms.items():
            rates[k].append(batch / device_time(embed, model, steps=steps))
    info = where(device)
    med = {k: float(np.median(v)) for k, v in rates.items()}
    rows = [emit({"metric": f"headline_compact_{k}", "value": med[k],
                  "unit": "videos/s", "runs": rates[k],
                  "vs_baseline": med[k] / med["attn_only"], **info}, out)
            for k in arms]
    rows.append(emit({"metric": "fused_mlp_on_compact_verdict",
                      "value": med["attn+mlp"] / med["attn_only"],
                      "unit": "speedup_attn+mlp_over_attn_only",
                      "vs_baseline": 1.0, **info}, out))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--skip-model", action="store_true")
    ap.add_argument("--skip-op", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device")
    args = ap.parse_args(argv)
    rows: list = []
    if not args.skip_op:
        bench_op_level(device=args.device, out=rows)
    if not args.skip_model:
        bench_model_level(repeats=args.repeats, device=args.device, out=rows)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
