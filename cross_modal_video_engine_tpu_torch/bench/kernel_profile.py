"""Where the two kernels designed for Hopper stand, and why.

    python -m cross_modal_video_engine_tpu_torch.bench.kernel_profile
        [sweep] [arms] [ablation]

`sweep` (JSON rows): csrc/gemm.cu by itself at the sublayers' shapes, ms
and TFLOP/s, with `F.linear` timed beside it; csrc/flash_attention.cu at
the caption path's shapes and at long sequences, with
`scaled_dot_product_attention` beside it.  Both library calls are
yardsticks only: nothing in the package calls them.  On `device="cpu"` the
rows time the plain versions and say so in their unit.

`arms` (text, card only): device time by kernel over one call of the CLIP
kernel arm (`encode_video_u8` at B=32, `encode_text` of 8) and of the
caption kernel arm (`forward_test`, 16 clips), from torch.profiler, with
the wall time of a call, the idle share, the host time of one kernel
launch through the wrappers, and the host time of one call of each public
sublayer wrapper beside its time back to back.

`ablation` (text, card and nvcc only): what each part of the flash
kernel's key-tile loop costs.  Copies of the package under
`build/ablation/<name>/` get one part of csrc/flash_attention.cu's
softmax cut out (the results are wrong, on purpose), are built, and time
the same three shapes as the unchanged copy.
"""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import attention_sublayer as asl
from ..ops.flash_attention import flash_attention
from ..utils.device import card_line, resolve_device
from ..utils.profiling import device_time, host_time
from .common import clip_arms, emit, flagship_config, per, where

# (M, K, N, epilogue, products sharing A): the ViT-B/32 sublayers at 16
# videos, at the headline's 128, and the text tower at 256 captions
GEMM_SHAPES = (
    (6400, 768, 3072, "gelu", 1), (6400, 3072, 768, "residual", 1),
    (6400, 768, 768, "bias", 3), (51200, 768, 3072, "gelu", 1),
    (51200, 3072, 768, "residual", 1), (19712, 512, 2048, "gelu", 1),
    (616, 512, 512, "bias", 3),
)
# (B, H, S, D, causal): the joint TimeSformer at 4 and 16 clips, its
# space-only shape, then long sequences at both head dims of the wgmma path
FLASH_SHAPES = (
    (4, 12, 1569, 64, False), (16, 12, 1569, 64, False),
    (128, 12, 197, 64, False), (1, 16, 8192, 64, False),
    (1, 16, 8192, 64, True), (1, 16, 8192, 128, False),
)
_EPI = {"bias": asl._EPI_BIAS, "gelu": asl._EPI_GELU,
        "residual": asl._EPI_RESID}


def bench_gemm(shapes=GEMM_SHAPES, steps: int = 20, device=None) -> list:
    device = resolve_device(device)
    run = asl._gemm if device.type == "cuda" else asl._gemm_ref
    gen = torch.Generator(device=device).manual_seed(0)
    out = []

    def randn(*shape, std):
        return (torch.randn(*shape, generator=gen, device=device)
                * std).to(torch.bfloat16)

    for m, k, n, epi, nmat in shapes:
        a = randn(m, k, std=0.5)
        mats = [(randn(n, k, std=k ** -0.5), randn(n, std=0.02))
                for _ in range(nmat)]
        resid = randn(m, n, std=0.5) if epi == "residual" else None
        with torch.no_grad():
            dt = device_time(lambda: run(a, _EPI[epi], mats, resid),
                             steps=steps, device=device)
            lib = device_time(
                lambda: [torch.nn.functional.linear(a, w, b)
                         for w, b in mats], steps=steps, device=device)
        flops = 2 * m * n * k * nmat
        emit({"metric": f"gemm_{epi}_M{m}_K{k}_N{n}_x{nmat}_bf16",
              "value": dt * 1e3, "unit": per("ms", device, "launch"),
              "tflops": flops / dt / 1e12, "f_linear_ms": lib * 1e3,
              "vs_baseline": lib / dt, **where(device)}, out)
    return out


def bench_flash(shapes=FLASH_SHAPES, steps: int = 20, device=None) -> list:
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for b, h, s, d, causal in shapes:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        with torch.no_grad():
            dt = device_time(lambda: flash_attention(q, k, v, scale, causal),
                             steps=steps, device=device)
            lib = device_time(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=scale),
                steps=steps, device=device)
        flops = 4 * b * h * s * s * d / (2 if causal else 1)
        emit({"metric": f"flash_B{b}_H{h}_S{s}_D{d}"
                        f"{'_causal' if causal else ''}_bf16",
              "value": dt * 1e3, "unit": per("ms", device, "launch"),
              "tflops": flops / dt / 1e12, "sdpa_ms": lib * 1e3,
              "vs_baseline": lib / dt, **where(device)}, out)
    return out


# -- device time by kernel ------------------------------------------------------

def _caption_arm(device):
    """The joint space-time TimeSformer ViT-B/16 (bf16, flash attention)
    with an RNN decoder of the shipped caption config's sizes (36 classes,
    5 steps), random weights from a seed."""
    from ..api import init_recognizer
    from ..models.decoder_head import RNNDecoderConfig
    from ..models.recognizer import random_state_dict
    from ..models.timesformer import TimeSformerConfig
    backbone = dict(num_frames=8, img_size=224, patch_size=16,
                    embed_dims=768, num_heads=12, num_layers=12,
                    attention_type="joint_space_time", dtype="bfloat16",
                    use_flash_attention=True)
    decoder = dataclasses.asdict(RNNDecoderConfig(num_classes=36))
    sd = random_state_dict(TimeSformerConfig(**backbone), seed=2,
                           decoder_cfg=RNNDecoderConfig(**decoder))
    return init_recognizer({"backbone": backbone, "decoder": decoder}, sd,
                           device=device)[0]


def _kernel_table(fn, calls: int, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    # kernels only: aten entries carry their kernels' device time too
    rows = [(e.key, e.self_device_time_total / calls / 1e3, e.count / calls)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"== {label}: wall {wall:.3f} ms per call, device kernels "
          f"{total:.3f} ms, idle share {1 - total / wall:.3f}")
    for key, ms, n in rows[:12]:
        print(f"   {ms:8.3f} ms  x{n:5.1f}  {key[:100]}")


def _host_us(fn, calls: int = 500) -> float:
    return host_time(fn, calls) * 1e6


def _sublayer_calls(device, gen) -> None:
    """Host us and device ms of one call of each public sublayer wrapper,
    parameters in the types the models store them in (LayerNorm float32,
    weights bfloat16), at the vision tower's rows for 16 videos and the
    text tower's for 8 queries."""
    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=device)
                * std).to(dtype)

    def ln(d):
        return [1.0 + randn(d, std=0.1, dtype=torch.float32),
                randn(d, std=0.1, dtype=torch.float32)]

    def attn(d):
        return ln(d) + [t for _ in range(4) for t in
                        (randn(d, d, std=d ** -0.5), randn(d, std=0.02))]

    def mlp(d):
        return ln(d) + [randn(4 * d, d, std=d ** -0.5),
                        randn(4 * d, std=0.02),
                        randn(d, 4 * d, std=(4 * d) ** -0.5),
                        randn(d, std=0.02)]

    xv, xt = randn(6400, 768, std=0.5), randn(8, 77, 512, std=0.5)
    pv, pt, mv, mt = attn(768), attn(512), mlp(768), mlp(512)
    calls = {
        "fused_attention_sublayer_compact (6400, 768) L=50":
            lambda: asl.fused_attention_sublayer_compact(
                xv, *pv, heads=12, seq_len=50),
        "fused_attention_sublayer (8, 77, 512) causal":
            lambda: asl.fused_attention_sublayer(
                xt, *pt, heads=8, valid_len=77, causal=True),
        "fused_mlp_sublayer (6400, 768)":
            lambda: asl.fused_mlp_sublayer(xv, *mv),
        "fused_mlp_sublayer (8, 77, 512)":
            lambda: asl.fused_mlp_sublayer(xt, *mt),
    }
    with torch.no_grad():
        for name, fn in calls.items():
            ms = device_time(fn, steps=20, device=device) * 1e3
            print(f"one call of {name}: host {_host_us(fn, 100):.1f} us, "
                  f"back to back {ms:.4f} ms a call")


def profile_arms(device=None) -> None:
    device = resolve_device(device)
    if device.type != "cuda":
        raise SystemExit("the kernel tables need the card")
    print(card_line())
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(616, 512, generator=gen, device=device).bfloat16()
    w = torch.randn(512, 512, generator=gen, device=device).bfloat16()
    b = torch.randn(512, generator=gen, device=device).bfloat16()
    for nmat in (1, 3):
        us = _host_us(lambda: asl._gemm(a, asl._EPI_BIAS, [(w, b)] * nmat))
        print(f"host time of one _gemm launch, {nmat} product(s): "
              f"{us:.1f} us")
    print(f"host time of one _layernorm launch: "
          f"{_host_us(lambda: asl._layernorm(a, b, b, 1e-5)):.1f} us")
    _sublayer_calls(device, gen)

    cfg = flagship_config()
    model, _ = clip_arms(cfg, device)
    rng = np.random.default_rng(1)
    res = cfg.image_resolution
    frames = torch.from_numpy(rng.integers(
        0, 256, (32, 8, res, res, 3), dtype=np.uint8)).to(device)
    _kernel_table(lambda: model.encode_video_u8(frames), 5,
                  "CLIP kernel arm, encode_video_u8 B=32")
    ids = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (8, cfg.context_length)).astype(np.int64)
    ).to(device)
    _kernel_table(lambda: model.encode_text(ids), 5,
                  "CLIP kernel arm, encode_text of 8")
    del model
    torch.cuda.empty_cache()
    caption = _caption_arm(device)
    clips = (torch.from_numpy(rng.integers(
        0, 256, (16, 8, 224, 224, 3), dtype=np.uint8)).to(device).float()
        - 127.5) / 127.5
    _kernel_table(lambda: caption.forward_test(clips), 3,
                  "caption kernel arm, forward_test of 16 clips")


# -- what each part of the flash loop costs ---------------------------------------

# name -> (old, new) edits of csrc/flash_attention.cu
ABLATIONS = {
    "unchanged": [],
    "no exp": [("pa = ex2_approx(MASKED ? pa - mna : fmaf(pa, scale2, -mna));",
                "pa = MASKED ? pa - mna : fmaf(pa, scale2, -mna);"),
               ("pb = ex2_approx(MASKED ? pb - mnb : fmaf(pb, scale2, -mnb));",
                "pb = MASKED ? pb - mnb : fmaf(pb, scale2, -mnb);")],
    "no max": [("mxa[c] = fmaxf(mxa[c], sa);", "mxa[c] = sa * 0.f;"),
               ("mxb[c] = fmaxf(mxb[c], sb);", "mxb[c] = sb * 0.f;")],
    "no sum": [("          sma[c] += pa;\n          smb[c] += pb;",
                "          if (nt == 0) {\n            sma[c] += pa;\n"
                "            smb[c] += pb;\n          }")],
    "no softmax": [("        softmax(kt, alpha_a, alpha_b);\n"
                    "        wgmma_wait<0>();",
                    "        alpha_a = alpha_b = 1.f;\n"
                    "        wgmma_wait<0>();")],
    "two stages": [("static constexpr int STAGES = HD == 64 ? 4 : 3;",
                    "static constexpr int STAGES = 2;")],
}
_ABLATION_RUN = '''
import sys
sys.path.insert(0, ".")
import torch
from cross_modal_video_engine_tpu_torch.ops.flash_attention import (
    flash_attention)
from cross_modal_video_engine_tpu_torch.utils.profiling import device_time
gen = torch.Generator(device="cuda").manual_seed(0)
cells = []
for b, h, s, d in ((4, 12, 1569, 64), (1, 16, 8192, 64), (1, 16, 8192, 128)):
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    with torch.no_grad():
        dt = device_time(lambda: flash_attention(q, k, v, d ** -0.5, False),
                         steps=20, warmup=5, device="cuda")
    cells.append(f"S={s} D={d}: {dt * 1e3:.4f} ms "
                 f"{4 * b * h * s * s * d / dt / 1e12:.0f} TFLOP/s")
print(f"{sys.argv[1]:12s} " + "; ".join(cells), flush=True)
'''


def flash_ablation() -> None:
    package = Path(__file__).resolve().parents[1]
    root = package.parent / "build" / "ablation"
    print(card_line())
    for name, edits in ABLATIONS.items():
        tree = root / name.replace(" ", "_")
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(package, tree / package.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = tree / package.name / "csrc" / "flash_attention.cu"
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"ablation {name!r}: flash_attention.cu no "
                                 f"longer holds {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        (tree / "run.py").write_text(_ABLATION_RUN)
        done = subprocess.run([sys.executable, "run.py", name], cwd=tree,
                              capture_output=True, text=True)
        print(done.stdout.strip() or done.stderr[-2000:], flush=True)


def main(argv=None) -> None:
    """No args: the sweep.  With args: the named parts, in order."""
    names = list(sys.argv[1:] if argv is None else argv) or ["sweep"]
    parts = {"sweep": lambda: (bench_gemm(), bench_flash()),
             "arms": profile_arms, "ablation": flash_ablation}
    unknown = [n for n in names if n not in parts]
    if unknown:
        raise SystemExit(f"unknown part(s) {unknown}; choose from "
                         f"{list(parts)}")
    for name in names:
        parts[name]()


if __name__ == "__main__":
    main()
