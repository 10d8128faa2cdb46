"""Where the whole-block kernel's time goes.

    python -m cross_modal_video_engine_tpu_torch.bench.block_profile
        [--nseq 128 1024]

Needs the card and nvcc.  Builds the package's kernels once more with
`-DCMVE_BLK_PROFILE` (`ops/_build.load_kernels(defines=...)`), runs the bf16
block kernel on the first layer of `block_ab.build_stack` at the vision
tower's geometry (L=50, D=768, 12 heads, hidden 3072), holds the output
against the uninstrumented kernel's, and prints the cycles thread 0 of
block 0 spent in each phase (clock64 stamps; a stamp costs some tens of
cycles, so read the shares, and take times from bench/block_ab.py).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops._build import load_kernels
from ..ops.attention_sublayer import fused_block_sublayer_compact
from ..utils.device import card_line
from .block_ab import build_stack

SEQ_LEN, WIDTH, HEADS = 50, 768, 12
# the kernel's BLK_MARK indices: its top level, then inside the steps
PHASES = ("x and its statistics", "q|k|v products", "q|k|v epilogue",
          "softmax(q k^T) v", "output projection", "y1 and its statistics",
          "hidden chunk products", "gelu epilogue", "second MLP product",
          "y", "up: products of a slab", "up: wait + barrier",
          "up: start loads + LayerNorm slab", "down: products of a step",
          "down: wait + barrier", "down: start loads")
TOP_LEVEL = 10


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nseq", type=int, nargs="+", default=[128, 1024])
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    lib = load_kernels(defines=("-DCMVE_BLK_PROFILE",)).lib
    scale = float(np.float32(1.0 / np.sqrt(WIDTH // HEADS)))
    print(card_line())
    for nseq in args.nseq:
        x, params = build_stack(nseq, SEQ_LEN, WIDTH, 1, dev)
        flat = [*params[0][0], *params[0][1]]
        with torch.no_grad():
            want = fused_block_sublayer_compact(x, *flat, heads=HEADS,
                                                seq_len=SEQ_LEN)
        got, prof = torch.empty_like(x), torch.zeros(len(PHASES), device=dev)
        err = lib.cmve_block_sublayer(
            1, x.data_ptr(), *[p.data_ptr() for p in flat], got.data_ptr(),
            prof.data_ptr(), x.shape[0], WIDTH, HEADS, flat[12].shape[0],
            SEQ_LEN, 0, 1e-5, scale, torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        if err != 0 or not torch.equal(got, want):
            raise SystemExit(f"instrumented kernel: CUDA error {err}, or its "
                             f"output differs from the package's kernel")
        cycles = prof.cpu().numpy()
        for lo, hi, title in ((0, TOP_LEVEL, "top level"),
                              (TOP_LEVEL, len(PHASES), "inside the steps")):
            total = float(cycles[lo:hi].sum())
            print(f"{x.shape[0]} rows, block 0, {title}: {total:.0f} cycles")
            for i in range(lo, hi):
                print(f"  {PHASES[i]:34s} {cycles[i]:11.0f} "
                      f"{100 * cycles[i] / total:5.1f}%")


if __name__ == "__main__":
    main()
