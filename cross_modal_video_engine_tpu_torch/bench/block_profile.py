"""Where the whole-block kernel's time goes.

    python -m cross_modal_video_engine_tpu_torch.bench.block_profile
        [--nseq 128 1024] [--variants]

Needs the card and nvcc.  Builds the package's kernels once more with
`-DCMVE_BLK_PROFILE` (`ops/_build.load_kernels(defines=...)`), runs the bf16
block kernel on the first layer of `block_ab.build_stack` at the vision
tower's geometry (L=50, D=768, 12 heads, hidden 3072), holds the output
against the uninstrumented kernel's, and prints the cycles thread 0 of
block 0 spent in each phase (clock64 stamps; a stamp costs some tens of
cycles, so read the shares, and take times from bench/block_ab.py).

`--variants` times the kernel (CUDA events, one layer) as the package
builds it and as `-DCMVE_BLK_NO_WGMMA` (every shape on the mma.sync route)
and `-DCMVE_BLK_NO_MMA` (the products of the weight stream skipped: the
load-side ceiling) build it, with the rate at which L2 then hands every
block all of a layer's weights.
"""

from __future__ import annotations

import argparse

import torch

from ..ops._build import load_kernels
from ..ops.attention_sublayer import _sm_scale, fused_block_sublayer_compact
from ..utils.device import card_line
from ..utils.profiling import device_time
from .block_ab import build_stack

SEQ_LEN, WIDTH, HEADS = 50, 768, 12
# the kernel's BLK_MARK indices: its top level, then inside the steps
PHASES = ("x and LN1(x)", "q|k|v products", "q|k|v epilogue",
          "softmax(q k^T) v", "output projection", "y1 and LN2(y1)",
          "hidden chunk products", "gelu epilogue", "second MLP product",
          "y", "up: products of a slab", "up: wait for the tile",
          "up: release (and refill)", "down: products of a tile",
          "down: wait for the tile", "down: release (and refill)")
TOP_LEVEL = 10
VARIANTS = ((), ("-DCMVE_BLK_NO_WGMMA",), ("-DCMVE_BLK_NO_MMA",))


def launch(lib, x, flat, out, scratch=None, *, heads=HEADS,
           seq_len=SEQ_LEN) -> None:
    """One bf16 launch of a build's `cmve_block_sublayer` on x (n, D)."""
    d = x.shape[1]
    err = lib.cmve_block_sublayer(
        1, x.data_ptr(), *[p.data_ptr() for p in flat], out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), x.shape[0], d,
        heads, flat[12].shape[0], seq_len, 0, 1e-5, _sm_scale(d // heads),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"block kernel: CUDA error {err}")


def weight_bytes_through_l2(x, flat, seq_len=SEQ_LEN) -> int:
    """Every block streams all of a layer's weights: blocks x bytes."""
    rows = (64 // seq_len) * seq_len
    blocks = -(-x.shape[0] // rows)
    return blocks * 2 * sum(flat[i].numel() for i in (2, 4, 6, 8, 12, 14))


def variants(nseq: int, dev) -> None:
    x, params = build_stack(nseq, SEQ_LEN, WIDTH, 1, dev)
    flat = [*params[0][0], *params[0][1]]
    out = torch.empty_like(x)
    l2 = weight_bytes_through_l2(x, flat)
    for defines in VARIANTS:
        lib = load_kernels(defines=defines).lib
        ms = device_time(lambda: launch(lib, x, flat, out), steps=5,
                         warmup=1, device=dev) * 1e3
        print(f"{x.shape[0]} rows, {' '.join(defines) or 'package build'}: "
              f"{ms:.4f} ms a layer; {l2 / 1e9:.2f} GB of weights through L2 "
              f"= {l2 / (ms * 1e-3) / 1e12:.2f} TB/s", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nseq", type=int, nargs="+", default=[128, 1024])
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(card_line())
    if args.variants:
        for nseq in args.nseq:
            variants(nseq, dev)
        return
    lib = load_kernels(defines=("-DCMVE_BLK_PROFILE",)).lib
    for nseq in args.nseq:
        x, params = build_stack(nseq, SEQ_LEN, WIDTH, 1, dev)
        flat = [*params[0][0], *params[0][1]]
        with torch.no_grad():
            want = fused_block_sublayer_compact(x, *flat, heads=HEADS,
                                                seq_len=SEQ_LEN)
        got, prof = torch.empty_like(x), torch.zeros(len(PHASES), device=dev)
        launch(lib, x, flat, got, prof)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit("instrumented kernel: its output differs from "
                             "the package's kernel")
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
