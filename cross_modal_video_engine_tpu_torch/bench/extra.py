"""Secondary benchmarks: the index and tower rows.

    python -m cross_modal_video_engine_tpu_torch.bench.extra [ROW ...]

The rows of the JAX package's bench_extra.py that the port has code for,
one JSON line per metric; with no argument, every row in order:

* `retrieval_p50`: top-10 of 64 queries over 1M x 512 bf16 rows, p50 of
  the device time over repeats; then the same over int8 rows, with
  recall@10 against the bf16 index;
* `int8_capacity`: 4M x 512 int8 rows, p50 and recall@10 against the exact
  f32 answer over the same rows;
* `flash_sweep`: flash attention TFLOP/s against the plain attention at
  the same shapes;
* `text_tower`: CLIP ViT-B/32 text tower, captions/s at 256 captions;
* `u8_ingest`: the flagship tower fed uint8 frames through
  `encode_video_u8`, videos/s;
* `train_step_timesformer`: one recognition train step of the divided
  TimeSformer ViT-B/16 (8x224, 400 classes) in bf16 with f32 masters
  (`make_cls_train_step(bf16=True)`, SGD with momentum), videos/s by CUDA
  events and TFLOP/s counted from the model's shapes;
* `train_step_slowfast`: one recognition train step of SlowFast-R50 4x16
  (the JAX row's `SlowFastConfig(alpha=8)`, 400 classes) on 32 clips of
  32x224² in bf16 with f32 masters and f32 BatchNorm statistics
  (`make_cls_train_step_stats(bf16=True)`, SGD with momentum), videos/s
  by CUDA events and TFLOP/s counted from the convolutions' shapes;
* `train_step_yolov5`, `train_step_yolov5_seg`: one train step of yolov5s
  (and yolov5s-seg, 32 masks) at 640 on 16 images in bf16 with f32
  masters (`make_yolo_train_step(bf16=True)`: three-group SGD and EMA),
  images/s by CUDA events;
* `host_feed`: the host decode through `io/pipeline.DecodePrefetcher` over
  the native libav batch decoder (its cv2 fallback where libav was not
  found, named in each row), videos/s per worker count, then the
  prefetcher feeding the fused CLIP ViT-B/32 tower's `encode_video_u8`
  end to end (see `bench_host_feed` for its fixture and its cuts).

Rows are drawn from a seed on the device.  Where a row has a plain arm,
`vs_baseline` is the kernel arm over the plain arm (the TimeSformer
train-step row: over the JAX row's 9 videos/s reference, per GPU of the
reference's 8; the SlowFast row: over the JAX row's 18 videos/s, its
estimate for one V100; the YOLO rows: over the 205 images/s of the JAX
rows' reference, yolov5's "2 days on one V100 for 300 COCO epochs").
Not carried over: the flatten_tokens A/B (a TPU layout) and the other
families' train-step rows (the parts of slice 5 that port them).
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
import struct
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.clip import CLIPConfig, CLIPModel, seeded_state_dict
from ..models.recognizer import Recognizer3D
from ..models.timesformer import TimeSformerConfig
from ..train.optim import OptaxOptimizer
from ..train.recognition_trainer import RecTrainState, make_cls_train_step
from ..ops.flash_attention import _reference_attention, flash_attention
from ..retrieval.index import RetrievalIndex, _normalize_queries
from ..utils.device import resolve_device
from ..utils.profiling import device_time
from .common import (clip_arms, emit, flagship_config, per, time_arms,
                     where)


def _random_rows(n_rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n_rows, dim) N(0, 1) rows drawn on the device, half a million at a
    time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.empty((n_rows, dim), dtype=torch.float32, device=device)
    for i in range(0, n_rows, 500_000):
        part = rows[i:i + 500_000]
        part.copy_(torch.randn(part.shape, generator=gen, device=device))
    return rows


def _search_p50(index: RetrievalIndex, qn: torch.Tensor, k: int, trials: int,
                steps: int) -> float:
    """p50 over `trials` of the device ms of one search (normalized
    queries on the device in, device results out)."""
    search = index.searcher()
    kk = min(k, index.n_active)
    times = [device_time(lambda: search(index.emb, index.scales, index.valid,
                                        qn, kk),
                         steps=steps, device=index.device)
             for _ in range(trials)]
    return float(np.percentile(times, 50)) * 1e3


def _recall(ids_ref: np.ndarray, ids: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(a)
                          for a, b in zip(ids_ref, ids)]))


def bench_retrieval_p50(n_rows: int = 1_000_000, dim: int = 512,
                        n_queries: int = 64, k: int = 10, trials: int = 5,
                        steps: int = 20, device=None) -> list:
    device = resolve_device(device)
    rows = _random_rows(n_rows, dim, 0, device)
    q = _random_rows(n_queries, dim, 1, device)
    qn = _normalize_queries(q)
    q_host = q.cpu().numpy()
    info = where(device)
    name = f"retrieval_p50_{n_rows // 1000}k_rows_q{n_queries}"

    index = RetrievalIndex(rows, capacity=n_rows, dtype=torch.bfloat16,
                           device=device)
    p50 = _search_p50(index, qn, k, trials, steps)
    ids_ref = index.search(q_host, k)[1]
    nbytes = index.emb.nbytes
    del index
    out = [emit({"metric": name, "value": p50,
                 "unit": per("ms", device, "device"),
                 "vs_baseline": 1.0, "index_bytes": nbytes, **info})]

    idx8 = RetrievalIndex(rows, capacity=n_rows, dtype=torch.int8,
                          device=device)
    p50_8 = _search_p50(idx8, qn, k, trials, steps)
    ids_8 = idx8.search(q_host, k)[1]
    out.append(emit({"metric": name + "_int8", "value": p50_8,
                     "unit": per("ms", device, "device"),
                     "vs_baseline": p50 / p50_8,
                     "recall_at_k_vs_bf16": _recall(ids_ref, ids_8),
                     "index_bytes": idx8.emb.nbytes + idx8.scales.nbytes,
                     **info}))
    return out


def bench_int8_capacity(n_rows: int = 4_000_000, dim: int = 512,
                        n_queries: int = 64, k: int = 10, trials: int = 5,
                        steps: int = 10, device=None) -> dict:
    """int8 rows at the size they exist for: p50, and recall@k against the
    exact f32 answer over the same rows."""
    device = resolve_device(device)
    rows = _random_rows(n_rows, dim, 4, device)
    q = _random_rows(n_queries, dim, 5, device)
    qn = _normalize_queries(q)
    q_host = q.cpu().numpy()

    idx8 = RetrievalIndex(rows, capacity=n_rows, dtype=torch.int8,
                          device=device)
    p50_8 = _search_p50(idx8, qn, k, trials, steps)
    ids_8 = idx8.search(q_host, k)[1]
    bytes8 = idx8.emb.nbytes + idx8.scales.nbytes
    del idx8       # before the f32 reference: both would double the peak

    ref = RetrievalIndex(rows, capacity=n_rows, dtype=torch.float32,
                         device=device)
    del rows
    ids_ref = ref.search(q_host, k)[1]
    return emit({
        "metric": f"int8_index_p50_{n_rows / 1e6:g}M_rows_q{n_queries}",
        "value": p50_8, "unit": per("ms", device, "device"),
        "vs_baseline": None,
        "recall_at_k_vs_f32": _recall(ids_ref, ids_8),
        "index_bytes_int8": bytes8, "index_bytes_f32": ref.emb.nbytes,
        **where(device)})


def bench_flash_sweep(batch: int = 4, heads: int = 8, head_dim: int = 128,
                      seq_lens: Sequence[int] = (512, 1024, 2048, 4096, 8192),
                      steps: int = 10, device=None) -> list:
    device = resolve_device(device)
    info = where(device)
    scale = 1.0 / math.sqrt(head_dim)
    out = []
    for s in seq_lens:
        gen = torch.Generator(device=device).manual_seed(1)
        q = torch.randn((batch, heads, s, head_dim), generator=gen,
                        device=device).to(torch.bfloat16)
        flops = 4.0 * batch * heads * s * s * head_dim       # q k^T and P v
        rate = {}
        with torch.no_grad():
            for name, fn in (("flash", flash_attention),
                             ("plain", _reference_attention)):
                dt = device_time(lambda: fn(q, q, q, scale, False),
                                 steps=steps, device=device)
                rate[name] = flops / dt / 1e12
        for name in ("flash", "plain"):
            out.append(emit({"metric": f"attention_{name}_S{s}_bf16",
                             "value": rate[name], "unit": "TFLOP/s",
                             "vs_baseline": rate[name] / rate["plain"],
                             **info}))
    return out


def _token_ids(rng, n: int, length: int, vocab: int) -> np.ndarray:
    return rng.integers(1, vocab, (n, length)).astype(np.int64)


def bench_text_tower(batch: int = 256, steps: int = 20, device=None,
                     cfg: Optional[CLIPConfig] = None) -> dict:
    device = resolve_device(device)
    cfg = cfg or flagship_config()
    kernel, plain = clip_arms(cfg, device)
    ids = torch.from_numpy(_token_ids(np.random.default_rng(2), batch,
                                      cfg.context_length,
                                      cfg.vocab_size)).to(device)

    def embed(model):
        with torch.no_grad():
            return model.encode_text(ids)

    value, base, rates = time_arms(embed, kernel, plain, batch, steps)
    return emit({"metric": "text_embed_throughput_vitb32_bf16",
                 "value": value, "unit": per("captions/sec", device),
                 "vs_baseline": value / base, "plain": base, "runs": rates,
                 **where(device)})


def bench_u8_ingest(batch: int = 32, frames: int = 8, steps: int = 20,
                    device=None, cfg: Optional[CLIPConfig] = None) -> dict:
    device = resolve_device(device)
    cfg = cfg or flagship_config()
    kernel, plain = clip_arms(cfg, device)
    res = cfg.image_resolution
    gen = torch.Generator(device=device).manual_seed(3)
    clip = torch.randint(0, 256, (batch, frames, res, res, 3), generator=gen,
                         device=device, dtype=torch.uint8)

    def embed(model):
        with torch.no_grad():
            return model.encode_video_u8(clip)[0]

    value, base, rates = time_arms(embed, kernel, plain, batch, steps)
    return emit({"metric": "video_embed_u8_ingest_vitb32_bf16_8f224",
                 "value": value, "unit": per("videos/sec", device),
                 "vs_baseline": value / base, "plain": base, "runs": rates,
                 **where(device)})


def timesformer_forward_flops(cfg: TimeSformerConfig, batch: int,
                              num_classes: int) -> float:
    """Operations (2 per multiply-add) of the matrix products of one
    forward of a TimeSformer classifier on `batch` videos: the patch
    embedding, each block's projections, attention scores and mixes and
    FFN, and the head.  A train step is 3x this (the backward computes two
    products for each of the forward's)."""
    d, t, p = cfg.embed_dims, cfg.time_tokens, cfg.num_patches
    macs = t * p * 3 * cfg.patch_size ** 2 * cfg.tubelet_size * d

    def attention(tokens: int, seqs: int, length: int) -> int:
        """q|k|v and output projections, scores and mix."""
        return tokens * 4 * d * d + seqs * 2 * length * length * d

    n = 1 + p * t
    if cfg.attention_type == "divided_space_time":
        block = (attention(p * t, p, t) + p * t * d * d     # temporal_fc
                 + attention(t * (p + 1), t, p + 1) + n * 8 * d * d)
    elif cfg.attention_type == "joint_space_time":
        block = attention(n, 1, n) + n * 8 * d * d
    else:                                          # space-only, per frame
        block = attention(t * (p + 1), t, p + 1) + t * (p + 1) * 8 * d * d
    macs += cfg.num_layers * block + d * num_classes
    return 2.0 * batch * macs


def bench_train_step_timesformer(batch: int = 4, steps: int = 10,
                                 device=None,
                                 cfg: Optional[TimeSformerConfig] = None,
                                 num_classes: int = 400) -> dict:
    """Recognition train throughput: the divided TimeSformer 8x224 (the
    JAX row's model, weights N(0, 0.02) from a numpy seed, dropouts 0),
    forward, backward and SGD step (momentum 0.9, lr 0.005) in bf16 with
    f32 masters."""
    device = resolve_device(device)
    cfg = cfg or TimeSformerConfig(drop_path_max=0.0, dropout_ratio=0.0)
    model = Recognizer3D(cfg, num_classes, device=device)
    rng = np.random.default_rng(5)
    model.load_state_dict({
        k: torch.from_numpy(rng.standard_normal(tuple(v.shape),
                                                dtype=np.float32) * 0.02)
        for k, v in model.state_dict().items()})
    clips = torch.from_numpy(rng.standard_normal(
        (batch, cfg.num_frames, cfg.img_size, cfg.img_size, 3))
        .astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, num_classes, batch)).to(device)
    state = [RecTrainState(model, OptaxOptimizer(
        model.named_parameters(), lr=0.005, kind="sgd", max_norm=None,
        momentum=0.9), 0)]
    step = make_cls_train_step(model, bf16=True, device=device)

    def run():
        state[0], _ = step(state[0], clips, labels)

    seconds = device_time(run, steps=steps, device=device)
    vps = batch / seconds
    flops = 3 * timesformer_forward_flops(cfg, batch, num_classes)
    return emit({"metric": f"train_step_timesformer_divst_8x224_b{batch}",
                 "value": vps, "unit": per("videos/sec", device),
                 "vs_baseline": vps / 9.0, "step_ms": seconds * 1e3,
                 "tflops_per_sec": flops / seconds / 1e12,
                 **where(device)})


def bench_train_step_slowfast(batch: int = 32, frames: int = 32,
                              steps: int = 8, device=None, cfg=None,
                              num_classes: int = 400,
                              img: int = 224) -> dict:
    """Recognition train throughput of the BatchNorm path: SlowFast-R50
    4x16 (the JAX row's model, parameters N(0, 0.02) from a numpy seed,
    dropout 0), forward, backward and SGD step (momentum 0.9, lr 0.005) in
    bf16 with f32 masters and statistics."""
    from ..models.recognizer import BackboneClassifier
    from ..models.resnet3d import SlowFast, SlowFastConfig, forward_flops
    from ..train.recognition_trainer import make_cls_train_step_stats
    device = resolve_device(device)
    model = BackboneClassifier(SlowFast(cfg or SlowFastConfig(alpha=8),
                                        device), num_classes,
                               dropout_ratio=0.0)
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape), dtype=np.float32) * 0.02))
    clips = torch.from_numpy(rng.standard_normal(
        (batch, frames, img, img, 3), dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, num_classes, batch)).to(device)
    flops = 3 * forward_flops(model, clips)
    state = [RecTrainState(model, OptaxOptimizer(
        model.named_parameters(), lr=0.005, kind="sgd", max_norm=None,
        momentum=0.9), 0)]
    step = make_cls_train_step_stats(model, bf16=True, device=device)

    def run():
        state[0], _ = step(state[0], clips, labels)

    seconds = device_time(run, steps=steps, device=device)
    vps = batch / seconds
    return emit({"metric": f"train_step_slowfast_r50_4x16_bf16_b{batch}",
                 "value": vps, "unit": per("videos/sec", device),
                 "vs_baseline": vps / 18.0, "step_ms": seconds * 1e3,
                 "tflops_per_sec": flops / seconds / 1e12,
                 **where(device)})


def _yolo_batch(rng, batch: int, img: int, max_targets: int, nc: int,
                masks: bool, device):
    cxy = rng.random((batch, max_targets, 2)) * 0.8 + 0.1
    wh = rng.random((batch, max_targets, 2)) * 0.2 + 0.02
    cls = rng.integers(0, nc, (batch, max_targets, 1))
    out = [rng.random((batch, img, img, 3), np.float32),
           np.concatenate([cls, cxy, wh], -1).astype(np.float32),
           np.ones((batch, max_targets), bool)]
    if masks:
        out.append((rng.random((batch, max_targets, img // 4, img // 4))
                    > 0.9).astype(np.float32))
    return [torch.from_numpy(a).to(device) for a in out]


def bench_train_step_yolov5(batch: int = 16, img: int = 640,
                            max_targets: int = 32, steps: int = 8,
                            bf16: bool = True, masks: int = 0, device=None,
                            width: float = 0.50) -> dict:
    """Detection (masks=0) or segmentation train throughput of yolov5s at
    `img`: forward, backward, three-group SGD and EMA, in bf16 with f32
    masters; weights from the training init (seed 0), boxes and masks
    from a numpy seed."""
    from ..losses.yolo import YoloHyp
    from ..models.yolo import YoloConfig, YoloV5
    from ..train.yolo_trainer import (YoloOptHyp, init_yolo_train_state,
                                      make_yolo_train_step,
                                      scaled_weight_decay)
    device = resolve_device(device)
    model = YoloV5(YoloConfig(depth_multiple=0.33, width_multiple=width,
                              img_size=img, masks=masks), device=device)
    state = [init_yolo_train_state(model, seed=0)]
    opt = YoloOptHyp()
    step = make_yolo_train_step(model, YoloHyp(), opt,
                                scaled_weight_decay(opt, batch), bf16=bf16,
                                device=device)
    images, targets, valid, *gt = _yolo_batch(
        np.random.default_rng(7), batch, img, max_targets, 80, masks > 0,
        device)
    extra = {"gt_masks": gt[0]} if gt else {}

    def run():
        state[0], _ = step(state[0], images, targets, valid, 0.01, 0.01,
                           0.937, **extra)

    seconds = device_time(run, steps=steps, device=device)
    ips = batch / seconds
    kind = "yolov5s_seg" if masks else "yolov5s"
    return emit({"metric": "train_step_%s_%d_%s_b%d"
                           % (kind, img, "bf16" if bf16 else "f32", batch),
                 "value": ips, "unit": per("imgs/sec", device),
                 "vs_baseline": ips / 205.0, "step_ms": seconds * 1e3,
                 **where(device)})


def bench_train_step_yolov5_seg(batch: int = 16, img: int = 640,
                                max_targets: int = 32, steps: int = 8,
                                bf16: bool = True, device=None,
                                width: float = 0.50) -> dict:
    """The segmentation row: yolov5s-seg, 32 masks on 128 prototypes
    (npr width-scaled from 256), the per-instance mask BCE at stride 4."""
    return bench_train_step_yolov5(batch=batch, img=img,
                                   max_targets=max_targets, steps=steps,
                                   bf16=bf16, masks=32, device=device,
                                   width=width)


# -- the host-feed row ----------------------------------------------------------

def write_raw_avi(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Write RGB uint8 (T, H, W, 3) frames as an uncompressed AVI: a RIFF
    with one `vids` stream of `DIB ` frames (BGR24, rows bottom-up, each
    padded to 4 bytes), a `movi` list of `00db` chunks and an `idx1`
    index of key frames.  A bench and test fixture: it needs neither cv2
    nor an encoder, and libav reads its pixels back exactly."""
    t, h, w, _ = frames.shape
    stride = (w * 3 + 3) & ~3
    size = stride * h

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(data)) + data + (
            b"\0" if len(data) % 2 else b"")

    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, 0x10, t, 0,
                       1, size, w, h, 0, 0, 0, 0)
    strh = (b"vidsDIB " + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0,
                                      t, size, 0xFFFFFFFF, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = b"LIST" + struct.pack("<I", 4 + 8 + len(avih) + 12 + 8
                                 + len(strh) + 8 + len(strf)) + b"hdrl"
    hdrl += chunk(b"avih", avih)
    hdrl += b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8
                                  + len(strf)) + b"strl"
    hdrl += chunk(b"strh", strh) + chunk(b"strf", strf)
    movi_size = 4 + t * (8 + size)
    idx1 = b"".join(struct.pack("<4sIII", b"00db", 0x10, 4 + i * (8 + size),
                                size) for i in range(t))
    riff = 4 + len(hdrl) + 8 + movi_size + 8 + len(idx1)
    row = np.zeros((h, stride), np.uint8)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff) + b"AVI " + hdrl)
        f.write(b"LIST" + struct.pack("<I", movi_size) + b"movi")
        for frame in frames:
            row[:, :w * 3] = frame[::-1, :, ::-1].reshape(h, w * 3)
            f.write(b"00db" + struct.pack("<I", size) + row.tobytes())
        f.write(chunk(b"idx1", idx1))


# the fixture each row names, by its files' extension
FIXTURE_KINDS = {".avi": "rawvideo-avi", ".mp4": "mp4v"}


def fixture_kind(paths: Sequence[str]) -> str:
    """"rawvideo-avi" for `write_raw_avi`'s `.avi` files, "mp4v" for cv2's
    `.mp4` ones; a mix or another extension raises ValueError."""
    exts = sorted({os.path.splitext(p)[1].lower() for p in paths})
    if len(exts) != 1 or exts[0] not in FIXTURE_KINDS:
        raise ValueError(f"host_feed: the sources must be all .avi or all "
                         f".mp4, not {exts}")
    return FIXTURE_KINDS[exts[0]]


def host_feed_decoder(kind: str) -> str:
    """The decoder that reads `kind` sources: "libav" where io/native
    built the decode library, else "cv2 (fallback)" (decode_videos_batch's
    per-video fallback) on mp4s.  Raises SystemExit naming the libav
    probe's verdict where no decoder can read them: cv2 crashes on the
    raw AVI, and without cv2 the fallback gives zeros."""
    from ..io.native import native_status
    status = native_status()
    if status["decode"] is not None:
        return "libav"
    why = f"host_feed: libav was not found ({status['libav']})"
    if kind == "rawvideo-avi":
        raise SystemExit(f"{why}, and cv2 cannot read the raw-AVI fixture")
    try:
        import cv2  # noqa: F401
    except ImportError:
        raise SystemExit(f"{why}, and cv2 is not installed: no decoder")
    return "cv2 (fallback)"


def write_host_feed_fixture(root: str, n_src: int = 4, src_frames: int = 64,
                            src_hw=(480, 640), seed: int = 9,
                            kind: str = "rawvideo-avi") -> List[str]:
    """`n_src` files of `src_frames` seeded RGB frames of `src_hw`: raw
    AVIs, or mp4s written through cv2 where `kind` is "mp4v"."""
    rng = np.random.default_rng(seed)
    ext = {v: k for k, v in FIXTURE_KINDS.items()}[kind]
    paths = []
    for i in range(n_src):
        frames = rng.integers(0, 256, (src_frames,) + tuple(src_hw) + (3,),
                              dtype=np.uint8)
        paths.append(os.path.join(root, f"s{i}{ext}"))
        if kind == "mp4v":
            from ..io.video_decode import write_test_video
            write_test_video(paths[-1], frames)
        else:
            write_raw_avi(paths[-1], frames)
    return paths


def decoded_zeros(frames_u8: np.ndarray) -> int:
    """The clips of a decoded batch whose first or last frame is all
    zeros: what decode_videos_batch gives for a video it failed on."""
    ends = frames_u8[:, [0, -1]].reshape(len(frames_u8), 2, -1)
    return int((~ends.any(-1)).any(-1).sum())


def host_decode_rate(paths: Sequence[str], indices: np.ndarray, batch: int,
                     n_workers: int, out_hw=(224, 224)) -> float:
    """Videos/s of one pass of DecodePrefetcher over the clips (decode
    and the fused resize only)."""
    from ..io.pipeline import DecodePrefetcher
    pf = DecodePrefetcher(paths, indices, out_hw=out_hw, batch_size=batch,
                          n_workers=n_workers)
    t0 = time.perf_counter()
    total = zeros = 0
    for b, _ in pf:
        total += b.shape[0]
        zeros += decoded_zeros(b)
    seconds = time.perf_counter() - t0
    assert total == len(paths)
    if zeros:
        raise RuntimeError(f"host_feed: {zeros} of {total} clips decoded "
                           f"as zeros")
    return len(paths) / seconds


def host_feed_e2e(model, paths: Sequence[str], indices: np.ndarray,
                  batch: int, n_workers: int = 2) -> dict:
    """DecodePrefetcher into `model.encode_video_u8` on the model's
    device, the tail batch padded to `batch`: {"videos_per_s", "seconds",
    "batches", "embeddings" (the last batch's, on the host)}."""
    from ..io.pipeline import DecodePrefetcher
    device = next(model.parameters()).device
    res = model.cfg.image_resolution
    pf = DecodePrefetcher(paths, indices, out_hw=(res, res),
                          batch_size=batch, n_workers=n_workers)
    t0 = time.perf_counter()
    out, done, batches, zeros = None, 0, 0, 0
    with torch.no_grad():
        for frames_u8, _ in pf:
            b = frames_u8.shape[0]
            zeros += decoded_zeros(frames_u8)
            if b != batch:               # pad the tail to the batch shape
                pad = np.zeros((batch - b,) + frames_u8.shape[1:], np.uint8)
                frames_u8 = np.concatenate([frames_u8, pad], 0)
            out = model.encode_video_u8(torch.from_numpy(frames_u8).to(
                device))[0][:b]
            done += b
            batches += 1
    embeddings = out.float().cpu().numpy()       # drains the last batch
    seconds = time.perf_counter() - t0
    assert done == len(paths)
    if zeros:
        raise RuntimeError(f"host_feed: {zeros} of {done} clips decoded "
                           f"as zeros")
    return {"videos_per_s": len(paths) / seconds, "seconds": seconds,
            "batches": batches, "embeddings": embeddings}


def bench_host_feed(n_videos: int = 96, frames: int = 8, batch: int = 32,
                    src_hw=(480, 640), src_frames: int = 64, n_src: int = 4,
                    workers_sweep: Sequence[int] = (1, 2, 4), device=None,
                    cfg: Optional[CLIPConfig] = None,
                    srcs: Optional[Sequence[str]] = None,
                    model: Optional[CLIPModel] = None) -> list:
    """The host-to-device pipeline, the counterpart of the JAX row
    (bench_extra.py bench_host_feed): decode through DecodePrefetcher
    over the native libav batch decoder, then the uint8 ingest of the
    fused CLIP ViT-B/32 tower (bf16, 8 frames, 224², batch 32, the tail
    padded to the batch).  One decode-only row per worker count
    (`host_decode_480p_to_224_w{n}`, videos/s of the host) and one
    end-to-end row (`host_feed_e2e_decode_embed_vitb32_bf16`).

    The fixture is uncompressed AVI (`write_raw_avi`, `"fixture":
    "rawvideo-avi"` in each row), which needs no encoder.  So the rate
    measures demux, seek, swscale, the C++ thread pool and the
    host-to-device copy, not an MPEG-4 decode, and is not compared with
    the JAX row's 350 videos/s (`vs_baseline` None).  Where libav was not
    found, the sources are mp4s written through cv2 (`"mp4v"`) and read by
    decode_videos_batch's per-video cv2 fallback (`"decoder": "cv2
    (fallback)"`): cv2 crashes on the raw AVI.  With neither, the row
    raises SystemExit naming the libav probe's verdict, and a clip that
    decodes as zeros raises, so no row times a decode of nothing.  Cut
    from the JAX row: 4 sources of 64 frames at 480x640 (236 MB on disk
    as raw AVI) instead of 12 of 300 frames; 96 clips of 8 uniformly
    sampled frames, round-robin over the sources, as there.

    srcs: fixture files already written (`src_frames` frames each, all
    `.avi` or all `.mp4`, the row's "fixture" read from the extension;
    None: write them into a temporary directory); model: the kernel arm
    already built and called once (None: build it from seed 0 and call it
    once before the timed loop)."""
    from ..io.native import native_available
    from ..io.pipeline import uniform_indices
    device = resolve_device(device)
    cfg = model.cfg if model is not None else cfg or flagship_config()
    res = cfg.image_resolution
    if srcs is None:
        kind = "rawvideo-avi" if native_available()["decode"] else "mp4v"
    else:
        kind = fixture_kind(srcs)
    info = {"fixture": kind, "decoder": host_feed_decoder(kind),
            **where(device)}
    tmp = None if srcs is not None else tempfile.mkdtemp(prefix="hostfeed_")
    rows = []
    try:
        if tmp is not None:
            srcs = write_host_feed_fixture(tmp, n_src, src_frames, src_hw,
                                           kind=kind)
        paths = [srcs[i % len(srcs)] for i in range(n_videos)]
        idx = uniform_indices(n_videos, src_frames, frames)
        for nw in workers_sweep:
            rate = host_decode_rate(paths, idx, batch, nw, (res, res))
            emit({"metric": f"host_decode_480p_to_224_w{nw}", "value": rate,
                  "unit": "videos/sec/host", "vs_baseline": None, **info},
                 rows)
        if model is None:
            model = CLIPModel(dataclasses.replace(cfg, fused_attn=True,
                                                  fused_mlp=True),
                              device=device)
            model.load_state_dict(seeded_state_dict(cfg, 0))
            model.eval().requires_grad_(False)
            with torch.no_grad():            # the first call's set-up
                model.encode_video_u8(torch.zeros(
                    (batch, frames, res, res, 3), dtype=torch.uint8,
                    device=device))
        e2e = host_feed_e2e(model, paths, idx, batch)
        emit({"metric": "host_feed_e2e_decode_embed_vitb32_bf16",
              "value": e2e["videos_per_s"], "unit": per("videos/sec", device),
              "vs_baseline": None, "batches": e2e["batches"], **info}, rows)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return rows


_BENCHES = [
    ("retrieval_p50", bench_retrieval_p50),
    ("int8_capacity", bench_int8_capacity),
    ("flash_sweep", bench_flash_sweep),
    ("text_tower", bench_text_tower),
    ("u8_ingest", bench_u8_ingest),
    ("train_step_timesformer", bench_train_step_timesformer),
    ("train_step_slowfast", bench_train_step_slowfast),
    ("train_step_yolov5", bench_train_step_yolov5),
    ("train_step_yolov5_seg", bench_train_step_yolov5_seg),
    ("host_feed", bench_host_feed),
]


def main(argv=None) -> None:
    """No args: every row in order.  With args: only the named rows."""
    names = list(sys.argv[1:] if argv is None else argv)
    table = dict(_BENCHES)
    unknown = [n for n in names if n not in table]
    if unknown:
        raise SystemExit(f"unknown bench(es) {unknown}; choose from "
                         f"{[n for n, _ in _BENCHES]}")
    for name, fn in _BENCHES:
        if not names or name in names:
            fn()


if __name__ == "__main__":
    main()
