#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py        (from the root of the repository)

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the CUDA sublayer kernels from csrc/ with nvcc for sm_90a;
3. checks each kernel against its plain PyTorch version on the card at
   the CLIP ViT-B/32 main-path shapes, in bf16 and f32, with times;
4. builds ViT-B/32 (widths 768/512, 12+12 layers, bf16) with random
   weights from a numpy seed and drives the main path once with the
   launch counters zeroed: uint8 videos through `encode_video_u8`, a bf16
   `RetrievalIndex` of 65,536 rows, text queries through `encode_text`,
   `search`; then checks the kernel arm against the plain arm
   (fused_attn=fused_mlp=False), the search against brute force, and the
   counters;
5. times videos/s of both arms at B=32, and one query wave (text tower
   of each arm, then the search);
6. prints a JSON line of kernel results and, last, a JSON line naming
   the device.

Exits non-zero, printing no result, when CUDA is unavailable or any
check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "cross_modal_video_engine_tpu_torch"

# max |kernel - plain|: f32 differs only in summation order; in bf16 the
# inputs below keep outputs under 4 in magnitude, where one bf16 step is
# 1.6e-2, and a one-step flip of an intermediate rounding may reach them
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
COSINE_MIN = 0.999                          # kernel arm vs plain arm
SRC = "cross_modal_video_engine_tpu_torch/csrc/"
TPU_SRC = "cross_modal_video_engine_tpu/ops/attention_sublayer.py"
VIDEOS, FRAMES, QUERIES, INDEX_ROWS, BENCH_VIDEOS = 16, 8, 8, 65536, 32
# bench.py's model: CLIP ViT-B/32, bf16
VIT_B32 = dict(embed_dim=512, image_resolution=224, vision_width=768,
               vision_layers=12, vision_heads=12, patch_size=32,
               context_length=77, vocab_size=49408, text_width=512,
               text_heads=8, text_layers=12, dtype="bfloat16")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sublayer_cases(dev):
    """The checks at the main-path shapes: each names the kernel, the
    input shape, how to make its parameters on the card from a generator,
    the kernel call and the plain call, and (for padded rows) how many
    leading rows are compared."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl

    def randn(gen, *shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    # lecun-normal scales, the output projections at half of it so that
    # the outputs (x at std 0.5 plus the sublayer) stay under 4
    def attn_params(gen, d):
        p = [1.0 + randn(gen, d, std=0.1), randn(gen, d, std=0.1)]
        for scale in (1.0, 1.0, 1.0, 0.5):
            p += [randn(gen, d, d, std=scale * d ** -0.5),
                  randn(gen, d, std=0.02)]
        return p

    def mlp_params(gen, d):
        return [1.0 + randn(gen, d, std=0.1), randn(gen, d, std=0.1),
                randn(gen, 4 * d, d, std=d ** -0.5),
                randn(gen, 4 * d, std=0.02),
                randn(gen, d, 4 * d, std=0.5 * (4 * d) ** -0.5),
                randn(gen, d, std=0.02)]

    n_vis = VIDEOS * FRAMES * 50
    cases = []

    def add(name, kernel, shape, make, run_kernel, run_ref, valid=None):
        cases.append(dict(name=name, kernel=kernel, shape=shape, make=make,
                          run_kernel=run_kernel, run_ref=run_ref,
                          valid=valid))

    add("compact vision", "fused_attention_sublayer_compact", (n_vis, 768),
        lambda g: attn_params(g, 768),
        lambda x, p: asl.fused_attention_sublayer_compact(
            x, *p, heads=12, seq_len=50),
        lambda x, p: asl._attn_ref_flat(x, *p, heads=12, seq_len=50,
                                        causal=False))
    add("rank-3 causal text", "fused_attention_sublayer", (8, 77, 512),
        lambda g: attn_params(g, 512),
        lambda x, p: asl.fused_attention_sublayer(
            x, *p, heads=8, valid_len=77, causal=True),
        lambda x, p: asl._attn_ref(x, *p, heads=8, valid_len=77,
                                   causal=True))
    add("rank-3 padded 80/77", "fused_attention_sublayer", (8, 80, 512),
        lambda g: attn_params(g, 512),
        lambda x, p: asl.fused_attention_sublayer(
            x, *p, heads=8, valid_len=77, causal=True),
        lambda x, p: asl._attn_ref(x, *p, heads=8, valid_len=77,
                                   causal=True), valid=77)
    add("mlp vision", "fused_mlp_sublayer", (n_vis, 768),
        lambda g: mlp_params(g, 768),
        lambda x, p: asl.fused_mlp_sublayer(x, *p),
        lambda x, p: asl._mlp_ref(x, *p))
    add("mlp text", "fused_mlp_sublayer", (8, 77, 512),
        lambda g: mlp_params(g, 512),
        lambda x, p: asl.fused_mlp_sublayer(x, *p),
        lambda x, p: asl._mlp_ref(x, *p))
    return cases


def check_kernels(dev):
    """Each kernel against its plain version; returns the per-case
    results and prints one line per case."""
    import torch
    results, failures = [], []
    for i, case in enumerate(sublayer_cases(dev)):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(1000 + i)
            params = case["make"](gen)
            x = (torch.randn(*case["shape"], generator=gen, device=dev)
                 * 0.5).to(dtype)
            with torch.no_grad():
                got = case["run_kernel"](x, params)
                want = case["run_ref"](x, params)
                torch.cuda.synchronize()
                v = case["valid"]
                finite = bool(torch.isfinite(got.float()).all())
                if v is not None:        # pad rows: finite, not compared
                    got, want = got[:, :v], want[:, :v]
                err = float((got.float() - want.float()).abs().max())
                ms = cuda_ms(lambda: case["run_kernel"](x, params))
                plain_ms = cuda_ms(lambda: case["run_ref"](x, params))
            name = str(dtype).removeprefix("torch.")
            ok = finite and err <= TOL[name]
            print(f"kernel {case['name']:22s} {name:8s} shape "
                  f"{tuple(case['shape'])}: max_abs_err {err:.3e} "
                  f"(tol {TOL[name]:g}) {'ok' if ok else 'FAIL'}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            results.append(dict(case=case["name"], kernel=case["kernel"],
                                dtype=name, err=err, ms=ms,
                                plain_ms=plain_ms))
            if not ok:
                failures.append(f"{case['name']} {name}: err {err} "
                                f"finite {finite}")
    if failures:
        raise SystemExit("kernel checks failed: " + "; ".join(failures))
    return results


def text_ids(rng, n: int, length: int = 77, vocab: int = 49408) -> np.ndarray:
    """Token ids shaped like BPE output: tokens, then EOT (the highest id),
    then zeros."""
    ids = np.zeros((n, length), np.int64)
    for r in range(n):
        eot = int(rng.integers(4, length))
        ids[r, :eot] = rng.integers(1, vocab - 2, eot)
        ids[r, eot] = vocab - 1
    return ids


def cosine_min(a, b) -> float:
    import torch
    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def drive_main_path(model, plain, cfg, dev, rng):
    """The main path once with the launch counters zeroed just before and
    read just after; then the checks of what came out.  Returns the
    counts, the index and the query ids."""
    import torch
    from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
    from cross_modal_video_engine_tpu_torch.retrieval.index import (
        RetrievalIndex, _normalize_queries)

    res, grid = cfg.image_resolution, cfg.grid
    frames = torch.from_numpy(rng.integers(
        0, 256, (VIDEOS, FRAMES, res, res, 3), dtype=np.uint8)).to(dev)
    ids = torch.from_numpy(text_ids(rng, QUERIES, cfg.context_length,
                                    cfg.vocab_size)).to(dev)
    noise = rng.standard_normal(
        (INDEX_ROWS - VIDEOS, cfg.embed_dim)).astype(np.float32)

    counters = (asl.fused_attention_sublayer_compact,
                asl.fused_attention_sublayer, asl.fused_mlp_sublayer)
    with torch.no_grad():
        for fn in counters:
            fn.launches = 0
        high, middle = model.encode_video_u8(frames)
        video_emb = high.mean(1).cpu().numpy()       # frame-mean per video
        index = RetrievalIndex(np.concatenate([video_emb, noise]),
                               device=dev, dtype=torch.bfloat16)
        queries = model.encode_text(ids)
        vals, idx = index.search(queries.cpu().numpy(), k=10)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}

        high_p, middle_p = plain.encode_video_u8(frames)
        queries_p = plain.encode_text(ids)

    checks = {
        "video shapes": (
            tuple(high.shape) == (VIDEOS, FRAMES, cfg.embed_dim)
            and tuple(middle.shape) == (VIDEOS, FRAMES, grid ** 2,
                                        cfg.vision_width)),
        "text shape": tuple(queries.shape) == (QUERIES, cfg.embed_dim),
        "finite": bool(torch.isfinite(high).all()
                       and torch.isfinite(middle.float()).all()
                       and torch.isfinite(queries).all()),
    }
    cos = {"video high": cosine_min(high, high_p),
           "video middle": cosine_min(middle, middle_p),
           "text": cosine_min(queries, queries_p)}
    print("kernel arm vs plain arm, min cosine: " + ", ".join(
        f"{k} {v:.6f}" for k, v in cos.items()) + f" (need >= {COSINE_MIN})")
    checks["cosine vs plain arm"] = min(cos.values()) >= COSINE_MIN

    # brute force over the same stored bf16 rows, in float64 on the host
    stored = index.emb[: index.n].double().cpu().numpy()
    qb = _normalize_queries(queries.float()).to(torch.bfloat16)
    sims = qb.double().cpu().numpy() @ stored.T
    brute = np.argsort(-sims, axis=1, kind="stable")[:, :10]
    same = all(set(a) == set(b) for a, b in zip(idx, brute))
    val_err = float(np.abs(vals - np.take_along_axis(sims, idx, 1)).max())
    print(f"search top-10 of {index.n} bf16 rows vs brute force: "
          f"{'equal' if same else 'DIFFERENT'}, max score err {val_err:.2e}")
    checks["search == brute force"] = same and val_err < 1e-4

    print(f"launch counters over the main path: {json.dumps(launches)}")
    checks["launch counters"] = (
        launches["fused_attention_sublayer_compact"] >= cfg.vision_layers
        and launches["fused_attention_sublayer"] >= cfg.text_layers
        and launches["fused_mlp_sublayer"]
        >= cfg.vision_layers + cfg.text_layers)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"main-path checks failed: {failed}")
    return launches, index, ids


def query_latency(model, plain, index, ids, card):
    """ms per query wave of QUERIES texts: the text tower of each arm,
    then the index search (host queries in, host results out)."""
    import torch
    with torch.no_grad():
        text = {arm: cuda_ms(lambda: m.encode_text(ids), iters=10)
                for arm, m in (("kernel", model), ("plain", plain))}
        q = model.encode_text(ids).cpu().numpy()
    search = cuda_ms(lambda: index.search(q, k=10), iters=10)
    print(f"query wave of {QUERIES} (ms): text tower kernel arm "
          f"{text['kernel']:.3f}, plain arm {text['plain']:.3f}; search "
          f"top-10 of {index.n} bf16 rows {search:.3f} on {card}")


def throughput(model, plain, cfg, dev, rng, card):
    """videos/s of both arms, in turns: plain, kernel, kernel, plain."""
    import torch
    res = cfg.image_resolution
    bench = torch.from_numpy(rng.integers(
        0, 256, (BENCH_VIDEOS, FRAMES, res, res, 3), dtype=np.uint8)).to(dev)
    rates = {"plain": [], "kernel": []}
    with torch.no_grad():
        for arm in ("plain", "kernel", "kernel", "plain"):
            m = model if arm == "kernel" else plain
            ms = cuda_ms(lambda: m.encode_video_u8(bench), iters=5,
                         warmup=2)
            rates[arm].append(BENCH_VIDEOS * 1000.0 / ms)
    for arm in ("kernel", "plain"):
        r = rates[arm]
        print(f"videos/s {arm} arm (ViT-B/32 bf16, {FRAMES}x{res}^2 uint8, "
              f"B={BENCH_VIDEOS}): {np.mean(r):.2f} (runs {r[0]:.2f}, "
              f"{r[1]:.2f}) on {card}")
    return rates


def kernel_json(results, launches) -> dict:
    """The kernels line: bf16 errors over every case of a kernel, times
    of its main-path case."""
    main_case = {"fused_attention_sublayer_compact": "compact vision",
                 "fused_attention_sublayer": "rank-3 causal text",
                 "fused_mlp_sublayer": "mlp vision"}
    sources = {"fused_attention_sublayer_compact": "attention_core.cu",
               "fused_attention_sublayer": "attention_core.cu",
               "fused_mlp_sublayer": "gemm.cu"}
    tpu_lines = {"fused_attention_sublayer_compact": 354,
                 "fused_attention_sublayer": 132,
                 "fused_mlp_sublayer": 479}
    kernels = []
    for name, case in main_case.items():
        bf16 = [r for r in results
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        main = next(r for r in bf16 if r["case"] == case)
        kernels.append({
            "name": name, "route": "cuda", "source": SRC + sources[name],
            "replaces": f"{TPU_SRC}:{tpu_lines[name]}",
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in bf16),
            "ms": main["ms"], "plain_ms": main["plain_ms"]})
    return {"kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    # the port and its CUDA sources come from this checkout, nowhere else
    if not (PACKAGE / "csrc").is_dir():
        print(f"chip_smoke: {PACKAGE} not found; run this script from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    from cross_modal_video_engine_tpu_torch.models.clip import (
        CLIPConfig, CLIPModel, enable_fused_inference, random_state_dict)
    from cross_modal_video_engine_tpu_torch.ops._build import load_kernels

    # plain f32 arms: full-f32 matmuls and convs (cuDNN would use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; TF32 off for f32 "
          f"matmul and cuDNN conv", flush=True)

    # -- 2. build -----------------------------------------------------------
    kern = load_kernels()
    print(f"kernels {'built' if kern.built else 'loaded'} in "
          f"{kern.seconds:.1f} s: {kern.path}")
    for line in kern.log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  ptxas:", line.strip())

    # -- 3. each kernel against its plain version ---------------------------
    results = check_kernels(dev)

    # -- 4. the main path ---------------------------------------------------
    cfg = CLIPConfig(**VIT_B32)
    t0 = time.perf_counter()
    sd = random_state_dict(cfg, seed=0)
    model = CLIPModel(enable_fused_inference(cfg, device=dev), device=dev)
    model.load_state_dict(sd)
    plain = CLIPModel(cfg, device=dev)
    plain.load_state_dict(sd)
    del sd
    if not (model.cfg.fused_attn and model.cfg.fused_mlp):
        raise SystemExit("enable_fused_inference left the kernels off")
    print(f"ViT-B/32 bf16 built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(1)
    launches, index, ids = drive_main_path(model, plain, cfg, dev, rng)

    # -- 5. videos/s and query latency --------------------------------------
    throughput(model, plain, cfg, dev, rng, card)
    query_latency(model, plain, index, ids, card)

    # -- 6. results ---------------------------------------------------------
    print(json.dumps(kernel_json(results, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
