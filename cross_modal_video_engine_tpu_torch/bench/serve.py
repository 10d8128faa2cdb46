"""Routes served over HTTP: LINAS at 1M rows, captions, composed retrieval,
explainable recognition.

    python -m cross_modal_video_engine_tpu_torch.bench.serve \
        [--rows 1000000] [--videos 1000] [--device cpu]
    python -m cross_modal_video_engine_tpu_torch.bench.serve --caption \
        [--device cpu]
    python -m cross_modal_video_engine_tpu_torch.bench.serve --composed \
        [--videos 1000] [--device cpu]
    python -m cross_modal_video_engine_tpu_torch.bench.serve --explain \
        [--device cpu]

The port's counterpart of the JAX package's bench_serve.py.  It writes,
from a numpy seed, everything the retrieval route reads: a collection in
the cli/common.py layout (BigFile frame features of 3-64 frames x 2048,
five captions a video, rnn and bow vocabularies of the shipped model's
sizes, 7807 and 7183) and a checkpoint of the full-width DualEncoding in
the JAX package's format.  Then it starts the server a user starts
(`cli.serve.build_service`, `service.app.create_server`), fills its index
with seeded rows up to `--rows` x 1536 (f32, capacity = rows), and
measures through HTTP on 127.0.0.1:

* batch-1: requests one after another, per-request p50/p99 ms; the same
  calls of the route's handler without HTTP (the batcher's wait and the
  wave);
* conc-64: 64 client threads in a Python process of their own, each sending its
  requests in turn, per-request p50/p99 ms and the batcher's waves and
  rows per wave;
* one wave of 1 and of 8 rows called directly, as the batcher calls it:
  the host clock per wave, the card's span of the wave by CUDA events,
  its kernels' busy time from torch.profiler, and the idle share
  1 - busy / wall.

The composed arm (`--composed`, `run_composed`) writes, from a numpy
seed, a CLIP RN50x4 checkpoint (`CLIPResNetConfig()`, f32) and a Combiner
in the reference checkpoint's conv4x4 layout (`CombinerConfig()`), both in
the JAX package's format, a toy BPE merges table, and a candidate
collection of `--videos` videos as the route's npz feature caches (high
(8, 640) and pooled middle (8, 16, 640) f32; the video files themselves
are empty names).  The reference videos are 64 frames of 360x480 uint8,
drawn from the seed and handed to the route already decoded (its `decode`
seam), so no video decode is timed.  It starts the `/composed_retrieval`
route and measures: batch-1 and conc-64 per-request p50/p99 over HTTP;
one wave of 1 and of 8 rows (text tower, Combiner, index product, one
fetch) as above; and the extraction of one reference video (preprocess,
RN50x4 over 64 frames, pooling), host ms with a synchronize and device ms
by CUDA events.

The caption arm (`--caption`, `run_caption`) writes, from a numpy seed, a
caption checkpoint in the JAX package's format: the TimeSformer ViT-B/16
with joint space-time attention through the flash kernel (8x224², width
768, 12 heads, 12 layers, bf16) and the RNN decoder of
configs/seq_generate/timesformer_relseq.py (36 classes, 5 steps).  Its
videos are 300 frames of 360x480, each frame drawn from the seed when the
pipeline asks for it (`SeededVideo`, handed to the route through its
`decode` seam), so no file is decoded and no large array is kept.  It
starts the `/caption` route and measures: batch-1 and conc-8 per-request
p50/p99 over HTTP (the host pipeline, the batcher's wait, the wave); one
wave of 1 and of 8 rows (clips to the device, forward_test, one fetch) as
above; and the host pipeline of one request (frame draw, sampling,
resize, crop, normalize) by itself.

The explain arm (`--explain`, `run_explain`) writes, from a numpy seed, a
Recognizer3D checkpoint in the JAX package's format (the caption arm's
backbone with a 400-class head) and concept banks (`symbolic` 80 x 768,
`cluster` 240 x 768), and serves the `/explain` route on the caption
arm's seeded videos through its `decode` seam.  It measures: batch-1
p50/p99 and a burst of 8 concurrent requests over HTTP; one wave of 1 and
of 8 rows (clips to the device, the capture forward, the class-score
gradient at the route's layer, one fetch) as above, with the capture
forward and the gradient timed apart, the flash launches of a wave and
its peak memory; and the host pipeline of one request.

Prints one JSON line per row.  On the CPU (`--device cpu`) the rows say
so and no device time is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..convert.from_jax import (clip_resnet_variables_to_jax,
                                clip_variables_to_jax,
                                combiner_variables_to_jax,
                                dual_encoding_variables_to_jax,
                                recognizer_variables_to_jax)
from ..data.composed_dataset import save_video_features
from ..explain.model_layers import get_model_layers
from ..io.bigfile import write_bigfile
from ..models import clip as clip_vit
from ..models import clip_resnet, combiner
from ..models.decoder_head import RNNDecoderConfig
from ..models.dual_encoding import DualEncodingConfig, seeded_state_dict
from ..models.recognizer import random_state_dict as recognizer_state_dict
from ..models.timesformer import TimeSformerConfig
from ..train.checkpoint import save_checkpoint
from ..utils.bpe import write_toy_merges
from ..utils.device import resolve_device
from ..utils.vocab import SPECIAL_TOKENS, Vocabulary
from .common import emit, per, where

COLLECTION, FEATURE = "linasbench", "feat2048"
# the checkout that holds the package
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def percentiles(ms: Sequence[float]) -> Dict[str, float]:
    a = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


# -- fixtures ---------------------------------------------------------------

def write_collection(root: str, cfg: DualEncodingConfig, n_videos: int,
                     caps_per_video: int = 5, min_frames: int = 3,
                     max_frames: int = 64, collection: str = COLLECTION,
                     seed: int = 0) -> dict:
    """A collection in the cli/common.py layout, from a numpy seed: videos
    of min_frames..max_frames frames of cfg.visual_feat_dim features,
    captions of 4-12 words from the rnn vocabulary (cfg.vocab_size - 4
    words), of which the first cfg.bow_vocab_size form the bow
    vocabulary.  Returns the paths and the captions."""
    rng = np.random.default_rng(seed)
    words = [f"w{i:05d}" for i in range(cfg.vocab_size - len(SPECIAL_TOKENS))]
    base = os.path.join(root, collection)
    feat_dir = os.path.join(base, "FeatureData", FEATURE)
    text_dir = os.path.join(base, "TextData")
    os.makedirs(text_dir, exist_ok=True)

    counts = rng.integers(min_frames, max_frames + 1, n_videos)
    names, video2frames = [], {}
    for i, nf in enumerate(counts):
        fids = [f"video{i}_f{j}" for j in range(nf)]
        video2frames[f"video{i}"] = fids
        names.extend(fids)
    feats = rng.standard_normal((len(names), cfg.visual_feat_dim),
                                dtype=np.float32)
    write_bigfile(feat_dir, names, feats)
    with open(os.path.join(feat_dir, "video2frames.txt"), "w") as f:
        f.write(repr(video2frames))

    lines, captions = [], []
    for i in range(n_videos):
        for c in range(caps_per_video):
            cap = " ".join(rng.choice(words, size=int(rng.integers(4, 13))))
            lines.append(f"video{i}#{c} {cap}")
            captions.append(cap)
    with open(os.path.join(text_dir, f"{collection}.caption.txt"), "w") as f:
        f.write("\n".join(lines))
    for style, vocab_words in (("rnn", words),
                               ("bow", words[:cfg.bow_vocab_size])):
        vocab = Vocabulary(style)
        for w in (list(SPECIAL_TOKENS) if style == "rnn" else []) + \
                list(vocab_words):
            vocab.add_word(w)
        d = os.path.join(text_dir, "vocabulary", style)
        os.makedirs(d, exist_ok=True)
        vocab.save(os.path.join(d, "word_vocab_5.json"))
    return dict(rootpath=root, collection=collection, feature=FEATURE,
                captions=captions, frames=int(counts.sum()))


def write_checkpoint(path: str, cfg: DualEncodingConfig, seed: int = 0
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint of `seeded_state_dict(cfg, seed)` in the JAX package's
    format; returns the state dict."""
    sd = seeded_state_dict(cfg, seed)
    save_checkpoint(path, dual_encoding_variables_to_jax(sd), cfg,
                    {"seed": seed})
    return sd


def fill_index(index, rows: int, seed: int = 0,
               chunk: int = 131072) -> None:
    """Add rows of N(0, 1) drawn on the index's device (a torch generator
    seeded with `seed`) until the index holds `rows` rows."""
    gen = torch.Generator(device=index.device).manual_seed(seed)
    while index.n < rows:
        m = min(chunk, rows - index.n)
        x = torch.randn((m, index.dim), generator=gen, device=index.device)
        index.add(x, ids=[f"filler{index.n + i}" for i in range(m)])


# -- the server and its clients ---------------------------------------------

def start_server(rootpath: str, checkpoint: str, device, rows: int,
                 index_cache: Optional[str] = None, seed: int = 0):
    """The retrieval route as `cli.serve` builds it, its index filled to
    `rows`, served on 127.0.0.1 (a free port) from a thread.  Returns
    (server, handler); stop with `stop_server`."""
    from ..cli.serve import build_service
    from ..service.app import create_server
    args = argparse.Namespace(
        retrieval_checkpoint=checkpoint, rootpath=rootpath,
        collection=COLLECTION, visual_feature=FEATURE,
        index_cache=index_cache, index_capacity=rows,
        device=None if device is None else str(device))
    service = build_service(args)
    handler = service.handlers["retrieval"]
    fill_index(handler.index, rows, seed)
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="retrieval-server")
    thread.start()
    return server, handler


def stop_server(server, handler) -> None:
    server.shutdown()
    server.server_close()
    handler.batcher.close()


# straight to 127.0.0.1: no proxy from the environment is consulted
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def request(port: int, route: str, payload: Optional[dict] = None,
            timeout: float = 120.0):
    """(ms, answer) of one POST (GET without a payload) to the route on
    127.0.0.1."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{route}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with _LOCAL.open(req, timeout=timeout) as r:
        out = json.loads(r.read())
    return (time.perf_counter() - t0) * 1e3, out


def _query(port: int, query: str, top_k: int) -> float:
    """ms of one /retrieval request; a short answer raises."""
    ms, out = request(port, "retrieval", {"query": query, "topK": top_k})
    if len(out["results"]) != top_k:
        raise RuntimeError(f"asked for {top_k} results, got "
                           f"{len(out['results'])}")
    return ms


def batch1(port: int, queries: Sequence[str], n: int, top_k: int = 10
           ) -> List[float]:
    """ms of n requests sent one after another."""
    return [_query(port, queries[i % len(queries)], top_k)
            for i in range(n)]


def _client_threads(port: int, queries: Sequence[str], clients: int,
                    per_client: int, top_k: int) -> List[float]:
    """ms of every request of `clients` threads, each sending
    `per_client` requests in turn; all threads start together."""
    lat: List[List[float]] = [[] for _ in range(clients)]
    errors: List[BaseException] = []
    barrier = threading.Barrier(clients)

    def client(c: int) -> None:
        try:
            barrier.wait()
            for i in range(per_client):
                lat[c].append(_query(
                    port, queries[(c * per_client + i) % len(queries)],
                    top_k))
        except BaseException as e:          # reported after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent clients failed: {errors[:1]}")
    return [ms for c in lat for ms in c]


def _client_main() -> None:
    """The client process: JSON arguments of `_client_threads` on stdin,
    the latencies as JSON on stdout."""
    args = json.load(sys.stdin)
    json.dump(_client_threads(**args), sys.stdout)


def concurrent(port: int, queries: Sequence[str], clients: int,
               per_client: int, top_k: int = 10) -> List[float]:
    """ms of every request of `clients` threads, each sending
    `per_client` requests in turn, all started together.  The threads run
    in a Python process of their own, since a server's clients never
    share its interpreter: in the server's process their Python work
    would take the interpreter lock from the handler threads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    args = dict(port=port, queries=list(queries), clients=clients,
                per_client=per_client, top_k=top_k)
    out = subprocess.run(
        [sys.executable, "-c", "from cross_modal_video_engine_tpu_torch."
         "bench.serve import _client_main; _client_main()"],
        input=json.dumps(args), capture_output=True, text=True, env=env,
        timeout=900)
    if out.returncode:
        raise RuntimeError(f"concurrent clients failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout)


def direct(handler, queries: Sequence[str], n: int, top_k: int = 10
           ) -> List[float]:
    """ms of n calls of the route's handler one after another, in this
    process, without HTTP: the batcher's wait and the wave."""
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        handler({"query": queries[i % len(queries)], "topK": top_k})
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


# -- one wave, timed ---------------------------------------------------------

def wave_rows(handler, queries: Sequence[str], n: int, top_k: int = 16):
    """The batcher's rows for the first n queries."""
    rows = []
    for q in queries[:n]:
        bow, ids = handler.dataset.process_cap(q)
        rows.append((ids, bow, top_k))
    return rows


def wave_times(handler, rows, calls: int = 50, device=None) -> dict:
    """One wave of `rows`, as the batcher runs it (text batch to the
    device, text tower, search, one fetch), `calls` times: wall ms per
    wave (host clock), the card's span of a wave by CUDA events (from the
    first enqueue to the last kernel's end), the kernels' busy ms a wave
    (torch.profiler) with the six longest kernels, and the idle share
    1 - busy / wall.  On the CPU only the wall is measured.  device: where
    the route computes (default: handler.model's device)."""
    device = device or handler.model.device
    run = handler.batcher.fn
    for _ in range(3):
        run(rows)
    t0 = time.perf_counter()
    for _ in range(calls):
        run(rows)
    wall = (time.perf_counter() - t0) / calls * 1e3
    out = {"wave_rows": len(rows), "calls": calls, "wall_ms": wall,
           "events_ms": None, "busy_ms": None, "idle_share": None,
           "top_kernels": None}
    if device.type != "cuda":
        return out
    spans = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(rows)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    kernels = device_kernels(lambda: run(rows), calls)
    out.update(events_ms=float(np.mean(spans)),
               idle_share=1.0 - kernels["busy_ms"] / wall, **kernels)
    return out


# -- the bench ---------------------------------------------------------------

def run(rows: int = 1_000_000, videos: int = 1000, device=None,
        root: Optional[str] = None, cfg: Optional[DualEncodingConfig] = None,
        n_single: int = 200, clients: int = 64, per_client: int = 20,
        wave_calls: int = 50, seed: int = 0) -> List[dict]:
    device = resolve_device(device)
    cfg = cfg or DualEncodingConfig()
    out: List[dict] = []
    root = root or os.path.join(_REPO, "build")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        info = write_collection(tmp, cfg, videos, seed=seed)
        ckpt = os.path.join(tmp, "ckpt")
        write_checkpoint(ckpt, cfg, seed)
        server, handler = start_server(tmp, ckpt, device, rows, seed=seed)
        try:
            port = server.server_address[1]
            caps = info["captions"]
            base = {"rows": rows, "dim": cfg.common_dim,
                    "index_dtype": "float32", **where(device)}
            lat = batch1(port, caps, n_single)
            p = percentiles(lat)
            emit({"metric": "serve_retrieval_batch1", "value": p["p50"],
                  "unit": per("ms", device), "p99": p["p99"],
                  "n": len(lat), **base}, out)
            lat = direct(handler, caps, n_single)
            p = percentiles(lat)
            emit({"metric": "serve_retrieval_handler_batch1",
                  "value": p["p50"], "unit": per("ms", device),
                  "p99": p["p99"], "n": len(lat), **base}, out)
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            lat = concurrent(port, caps, clients, per_client)
            waves = handler.batcher.batches_run - w0
            p = percentiles(lat)
            emit({"metric": f"serve_retrieval_conc{clients}",
                  "value": p["p50"], "unit": per("ms", device),
                  "p99": p["p99"], "n": len(lat), "waves": waves,
                  "rows_per_wave": (handler.batcher.rows_run - r0) / waves,
                  **base}, out)
            for n in (1, 8):
                t = wave_times(handler, wave_rows(handler, caps, n),
                               wave_calls)
                emit({"metric": f"serve_retrieval_wave{n}",
                      "value": t["wall_ms"], "unit": per("ms", device),
                      **t, **base}, out)
            emit({"metric": "serve_metrics",
                  "value": request(port, "metrics")[1], **base}, out)
        finally:
            stop_server(server, handler)
    return out


# -- composed retrieval -----------------------------------------------------

REF_FRAMES, REF_HEIGHT, REF_WIDTH = 64, 360, 480
# the candidates' stored features: frames, pooled middle tokens
CAND_FRAMES, CAND_TOKENS = 8, 16
EDITS = ["make it red", "the same scene at night", "with a dog instead",
         "zoom in on the person", "now it is raining", "add a second car",
         "show it from above", "the person is running"]


def write_clip_checkpoint(path: str, cfg, seed: int = 0) -> None:
    """A CLIP checkpoint of random weights from a numpy seed in the JAX
    package's format: the ModifiedResNet tower for a CLIPResNetConfig,
    else a ViT."""
    if isinstance(cfg, clip_resnet.CLIPResNetConfig):
        sd = clip_resnet.random_state_dict(cfg, seed)
        variables = clip_resnet_variables_to_jax(sd, cfg)
    else:
        sd = clip_vit.random_state_dict(cfg, seed)
        variables = clip_variables_to_jax(sd, cfg)
    save_checkpoint(path, variables, cfg, {"seed": seed})


def write_combiner_checkpoint(path: str, cfg, seed: int = 0) -> None:
    sd = combiner.random_state_dict(cfg, seed)
    save_checkpoint(path, combiner_variables_to_jax(sd, cfg), cfg,
                    {"seed": seed})


def write_candidates(videos_dir: str, cache_dir: str, n: int, dim: int,
                     seed: int = 0) -> List[str]:
    """n candidate videos as the route reads them: an empty `.mp4` name
    each in videos_dir, and its npz feature cache in cache_dir with high
    (8, dim) and pooled middle (8, 16, dim) f32 of N(0, 1) from a numpy
    seed.  Returns the names."""
    rng = np.random.default_rng(seed)
    os.makedirs(videos_dir, exist_ok=True)
    os.makedirs(cache_dir, exist_ok=True)
    names = [f"cand{i:05d}.mp4" for i in range(n)]
    for name in names:
        open(os.path.join(videos_dir, name), "w").close()
        save_video_features(
            os.path.join(cache_dir, name + ".npz"),
            rng.standard_normal((CAND_FRAMES, dim), dtype=np.float32),
            rng.standard_normal((CAND_FRAMES, CAND_TOKENS, dim),
                                dtype=np.float32))
    return names


def reference_videos(n: int, seed: int = 0, frames: int = REF_FRAMES,
                     height: int = REF_HEIGHT, width: int = REF_WIDTH
                     ) -> Dict[str, np.ndarray]:
    """n decoded reference videos, uint8 (frames, height, width, 3) from a
    numpy seed, by name (`decode=videos.__getitem__` serves them)."""
    rng = np.random.default_rng(seed)
    return {f"ref{i}": rng.integers(0, 256, (frames, height, width, 3),
                                    dtype=np.uint8) for i in range(n)}


def write_composed_fixtures(root: str, clip_cfg, comb_cfg, videos: int,
                            seed: int = 0) -> argparse.Namespace:
    """Both checkpoints, the merges table and the candidates under root;
    returns the route's arguments (device unset)."""
    paths = argparse.Namespace(
        clip_checkpoint=os.path.join(root, "clip"),
        combiner_checkpoint=os.path.join(root, "combiner"),
        merges=os.path.join(root, "merges.txt"),
        videos_dir=os.path.join(root, "videos"),
        feature_cache=os.path.join(root, "features"))
    write_clip_checkpoint(paths.clip_checkpoint, clip_cfg, seed)
    write_combiner_checkpoint(paths.combiner_checkpoint, comb_cfg, seed + 1)
    write_toy_merges(paths.merges, EDITS, n_merges=64)
    write_candidates(paths.videos_dir, paths.feature_cache, videos,
                     comb_cfg.clip_feature_dim, seed + 2)
    return paths


def start_composed_server(args: argparse.Namespace, decode):
    """The composed route as `cli.serve` builds it, on 127.0.0.1 (a free
    port) from a thread.  Returns (server, handler)."""
    from ..cli.serve import build_service
    from ..service.app import create_server
    service = build_service(args, decode=decode)
    handler = service.handlers["composed_retrieval"]
    server = create_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="composed-server").start()
    return server, handler


def composed_payloads(refs: Sequence[str], n: int, top_k: int = 10
                      ) -> List[dict]:
    return [{"reference_video": refs[i % len(refs)],
             "text": EDITS[i % len(EDITS)], "topK": top_k}
            for i in range(n)]


def _post_composed(port: int, payload: dict) -> float:
    ms, out = request(port, "composed_retrieval", payload, timeout=600.0)
    if len(out["results"]) != payload["topK"]:
        raise RuntimeError(f"asked for {payload['topK']} results, got "
                           f"{len(out['results'])}")
    return ms


def composed_wave_rows(handler, videos: Dict[str, np.ndarray], n: int):
    """The batcher's rows of the first n payloads."""
    rows = []
    for p in composed_payloads(sorted(videos), n):
        h, m = handler.reference_features(videos[p["reference_video"]])
        rows.append((h, m, handler.tokenizer.tokenize(
            p["text"], handler.clip_cfg.context_length)))
    return rows


def extraction_times(handler, frames_u8: np.ndarray, calls: int = 10
                     ) -> dict:
    """One reference video through the route's extraction (to the device,
    preprocess, the vision tower, pooling), `calls` times after a warm-up:
    host ms with a synchronize, and on a card device ms by CUDA events and
    the kernels' busy ms a call (torch.profiler) with the six longest."""
    device = next(handler.clip_model.parameters()).device
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    handler.reference_features(frames_u8)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        handler.reference_features(frames_u8)
    sync()
    out = {"frames": int(frames_u8.shape[0]),
           "wall_ms": (time.perf_counter() - t0) / calls * 1e3,
           "events_ms": None}
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            handler.reference_features(frames_u8)
        end.record()
        end.synchronize()
        out["events_ms"] = start.elapsed_time(end) / calls
        out.update(device_kernels(
            lambda: handler.reference_features(frames_u8), calls))
    return out


def device_kernels(fn, calls: int) -> dict:
    """The card's kernels over `calls` calls of fn() (torch.profiler,
    device entries only: aten entries and annotations carry their
    kernels' time too): busy ms a call and the six longest, ms a call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / calls / 1e3, e.key)
                      for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")
                      and not getattr(e, "is_user_annotation", False)),
                     reverse=True)
    return {"busy_ms": sum(ms for ms, _ in kernels),
            "top_kernels": [[key[:80], ms] for ms, key in kernels[:6]]}


def run_composed(videos: int = 1000, device=None, root: Optional[str] = None,
                 clip_cfg=None, comb_cfg=None, n_single: int = 32,
                 clients: int = 64, per_client: int = 2,
                 wave_calls: int = 20, n_refs: int = 4,
                 ref_shape=(REF_FRAMES, REF_HEIGHT, REF_WIDTH),
                 seed: int = 0) -> List[dict]:
    device = resolve_device(device)
    clip_cfg = clip_cfg or clip_resnet.CLIPResNetConfig()
    comb_cfg = comb_cfg or combiner.CombinerConfig(middle_mix="conv4x4")
    out: List[dict] = []
    root = root or os.path.join(_REPO, "build")
    os.makedirs(root, exist_ok=True)
    refs = reference_videos(n_refs, seed + 3, *ref_shape)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        args = write_composed_fixtures(tmp, clip_cfg, comb_cfg, videos, seed)
        args.device = str(device)
        server, handler = start_composed_server(args, refs.__getitem__)
        try:
            port = server.server_address[1]
            base = {"videos": videos, "ref_frames": ref_shape[0],
                    "ref_size": list(ref_shape[1:]),
                    "clip": type(clip_cfg).__name__,
                    "middle_mix": comb_cfg.middle_mix, **where(device)}
            names = sorted(refs)
            k = min(10, videos)
            _post_composed(port, composed_payloads(names, 1, k)[0])  # warm
            lat = [_post_composed(port, p)
                   for p in composed_payloads(names, n_single, k)]
            p = percentiles(lat)
            emit({"metric": "serve_composed_batch1", "value": p["p50"],
                  "unit": per("ms", device), "p99": p["p99"],
                  "n": len(lat), **base}, out)
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            lat = clients_in_threads(port, composed_payloads(
                names, clients * per_client, k), clients, _post_composed)
            waves = handler.batcher.batches_run - w0
            p = percentiles(lat)
            emit({"metric": f"serve_composed_conc{clients}",
                  "value": p["p50"], "unit": per("ms", device),
                  "p99": p["p99"], "n": len(lat), "waves": waves,
                  "rows_per_wave": (handler.batcher.rows_run - r0) / waves,
                  **base}, out)
            for n in (1, 8):
                t = wave_times(handler, composed_wave_rows(handler, refs, n),
                               wave_calls, device=device)
                emit({"metric": f"serve_composed_wave{n}",
                      "value": t["wall_ms"], "unit": per("ms", device),
                      **t, **base}, out)
            t = extraction_times(handler, refs[names[0]])
            emit({"metric": "serve_composed_extract", "value": t["wall_ms"],
                  "unit": per("ms", device), **t, **base}, out)
        finally:
            stop_server(server, handler)
    return out


def clients_in_threads(port: int, payloads: Sequence[dict], clients: int,
                       post) -> list:
    """What post(port, payload) returns for every payload, in the
    payloads' order, sent by `clients` threads started together, each
    posting its share in turn.  The work of a request is the route's (the
    video is decoded and encoded on the server), so the threads share
    this process."""
    out: list = [None] * len(payloads)
    errors: List[BaseException] = []
    barrier = threading.Barrier(clients)

    def client(c: int) -> None:
        try:
            barrier.wait()
            for i in range(c, len(payloads), clients):
                out[i] = post(port, payloads[i])
        except BaseException as e:          # reported after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent clients failed: {errors[:1]}")
    return out


# -- captions ------------------------------------------------------------------

# the caption route's model: TimeSformer ViT-B/16, joint space-time through
# the flash kernel, bf16, with the shipped caption config's decoder
CAPTION_BACKBONE = dict(num_frames=8, img_size=224, patch_size=16,
                        embed_dims=768, num_heads=12, num_layers=12,
                        attention_type="joint_space_time", dtype="bfloat16",
                        use_flash_attention=True)
CAPTION_CONFIG = os.path.join(_REPO, "configs", "seq_generate",
                              "timesformer_relseq.py")
VIDEO_FRAMES, VIDEO_HEIGHT, VIDEO_WIDTH = 300, 360, 480


def shipped_caption_model() -> dict:
    """The `model` tree of configs/seq_generate/timesformer_relseq.py."""
    return Config.fromfile(CAPTION_CONFIG)["model"]


def write_caption_checkpoint(path: str, backbone: dict, decoder: dict,
                             seed: int = 0, logit_scale: float = 1.0
                             ) -> Dict[str, torch.Tensor]:
    """A caption checkpoint of random f32 weights from a numpy seed
    (`models.recognizer.random_state_dict`) in the JAX package's format,
    config {"backbone", "decoder"}; returns the state dict.  logit_scale
    multiplies the decoder's output layer: at 1 the random model's step
    probabilities gather near 0.5, where a label may flip with rounding;
    a larger scale spreads them away from the threshold."""
    cfg = TimeSformerConfig(**backbone)
    sd = recognizer_state_dict(cfg, seed,
                               decoder_cfg=RNNDecoderConfig(**decoder))
    for key in [k for k in sd if k.startswith("cls_head.out.")]:
        sd[key] = sd[key] * logit_scale
    save_checkpoint(path, recognizer_variables_to_jax(sd, cfg),
                    {"backbone": backbone, "decoder": decoder},
                    {"seed": seed})
    return sd


class SeededVideo:
    """A decord-alike reader (`__len__`, `fps`, `get_batch`, `release`)
    of a video that exists only as a seed: frame i is uint8 (height,
    width, 3) drawn from numpy's generator seeded with (seed, i) when it
    is asked for.  Smooth colour ramps plus noise, so a resize sees both
    edges and flat areas."""

    def __init__(self, seed: int, frames: int = VIDEO_FRAMES,
                 height: int = VIDEO_HEIGHT, width: int = VIDEO_WIDTH):
        self.seed, self.n, self.shape = seed, frames, (height, width)
        self.fps = 30.0

    def __len__(self) -> int:
        return self.n

    def frame(self, i: int) -> np.ndarray:
        h, w = self.shape
        rng = np.random.default_rng((self.seed, int(i)))
        ys = (np.arange(h)[:, None] * rng.uniform(0, 2, 3)) % 256
        xs = (np.arange(w)[:, None] * rng.uniform(0, 2, 3)) % 256
        noise = np.frombuffer(rng.bytes(h * w * 3), np.uint8).reshape(
            h, w, 3) >> 2
        # uint8 sums wrap around, as the ramps do
        return (ys.astype(np.uint8)[:, None] + xs.astype(np.uint8)[None]
                + noise)

    def get_batch(self, indices) -> np.ndarray:
        return np.stack([self.frame(i) for i in indices])

    def release(self) -> None:
        pass


def seeded_videos(n: int, seed: int = 0, **shape) -> Dict[str, SeededVideo]:
    """n seeded videos by name (`decode=videos.__getitem__` opens them)."""
    return {f"video{i}.mp4": SeededVideo(seed * 1000 + i, **shape)
            for i in range(n)}


def start_route_server(args: argparse.Namespace, route: str, **decode):
    """One route as `cli.serve.build_service(args, **decode)` builds it,
    on 127.0.0.1 (a free port) from a thread.  Returns (server,
    handler)."""
    from ..cli.serve import build_service
    from ..service.app import create_server
    service = build_service(args, **decode)
    handler = service.handlers[route]
    server = create_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"{route}-server").start()
    return server, handler


def start_caption_server(args: argparse.Namespace, decode):
    """The caption route with `decode` as its seam: (server, handler)."""
    return start_route_server(args, "caption", caption_decode=decode)


def post_caption(port: int, payload: dict) -> float:
    """ms of one /caption request; an answer of the wrong length raises."""
    ms, out = request(port, "caption", payload, timeout=600.0)
    if not isinstance(out.get("steps"), list) or not out["steps"]:
        raise RuntimeError(f"caption answer without steps: {out}")
    return ms


def caption_wave_rows(handler, names: Sequence[str], n: int):
    """The batcher's rows (the pipeline's clips) of n requests."""
    return [np.asarray(handler.pipeline({"filename": names[i % len(names)],
                                         "start_index": 0})["imgs"],
                       np.float32) for i in range(n)]


def pipeline_times(handler, names: Sequence[str], calls: int = 10) -> dict:
    """The route's host pipeline (frame draw or decode, sampling, resize,
    crop, normalize) of one request on the host clock: ms a call, and ms
    a call of each op (`ops_ms`, by op name; DecordDecode holds the
    reader's get_batch)."""
    ops = handler.pipeline.ops
    spent = [0.0] * len(ops)
    caption_wave_rows(handler, names, 1)                    # warm-up
    t0 = time.perf_counter()
    for i in range(calls):
        results = {"filename": names[i % len(names)], "start_index": 0}
        for j, op in enumerate(ops):
            t = time.perf_counter()
            results = op(results)
            spent[j] += time.perf_counter() - t
        np.asarray(results["imgs"], np.float32)
    return {"calls": calls,
            "wall_ms": (time.perf_counter() - t0) / calls * 1e3,
            "ops_ms": {type(op).__name__: ms / calls * 1e3
                       for op, ms in zip(ops, spent)}}


def run_caption(device=None, root: Optional[str] = None,
                backbone: Optional[dict] = None,
                decoder: Optional[dict] = None, n_single: int = 32,
                clients: int = 8, per_client: int = 4,
                wave_calls: int = 20, n_videos: int = 8,
                video_shape=(VIDEO_FRAMES, VIDEO_HEIGHT, VIDEO_WIDTH),
                seed: int = 0) -> List[dict]:
    device = resolve_device(device)
    backbone = backbone or CAPTION_BACKBONE
    decoder = decoder or shipped_caption_model()["decoder"]
    out: List[dict] = []
    root = root or os.path.join(_REPO, "build")
    os.makedirs(root, exist_ok=True)
    frames, height, width = video_shape
    videos = seeded_videos(n_videos, seed + 1, frames=frames, height=height,
                           width=width)
    names = sorted(videos)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        args = argparse.Namespace(
            caption_checkpoint=os.path.join(tmp, "caption"),
            device=str(device))
        write_caption_checkpoint(args.caption_checkpoint, backbone, decoder,
                                 seed)
        server, handler = start_caption_server(args, videos.__getitem__)
        try:
            port = server.server_address[1]
            base = {"video_frames": frames, "video_size": [height, width],
                    "attention_type": backbone["attention_type"],
                    "dtype": backbone.get("dtype", "float32"),
                    "layers": backbone["num_layers"], **where(device)}
            payloads = [{"video": names[i % len(names)], "threshold": 0.5}
                        for i in range(max(n_single, clients * per_client))]
            post_caption(port, payloads[0])                    # warm-up
            lat = [post_caption(port, p) for p in payloads[:n_single]]
            p = percentiles(lat)
            emit({"metric": "serve_caption_batch1", "value": p["p50"],
                  "unit": per("ms", device), "p99": p["p99"],
                  "n": len(lat), **base}, out)
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            lat = clients_in_threads(port, payloads[:clients * per_client],
                                      clients, post_caption)
            waves = handler.batcher.batches_run - w0
            p = percentiles(lat)
            emit({"metric": f"serve_caption_conc{clients}",
                  "value": p["p50"], "unit": per("ms", device),
                  "p99": p["p99"], "n": len(lat), "waves": waves,
                  "rows_per_wave": (handler.batcher.rows_run - r0) / waves,
                  **base}, out)
            for n in (1, 8):
                t = wave_times(handler, caption_wave_rows(handler, names, n),
                               wave_calls, device=device)
                emit({"metric": f"serve_caption_wave{n}",
                      "value": t["wall_ms"], "unit": per("ms", device),
                      **t, **base}, out)
            t = pipeline_times(handler, names)
            emit({"metric": "serve_caption_pipeline", "value": t["wall_ms"],
                  "unit": "ms/host", **t, **base}, out)
        finally:
            stop_server(server, handler)
    return out


# -- explainable recognition ---------------------------------------------------

# the explain route's model: the caption route's backbone (TimeSformer
# ViT-B/16, joint space-time through the flash kernel, bf16) with a
# Kinetics-400 classifier head
EXPLAIN_CLASSES = 400
# concept banks: one symbolic vector per object class of the detector
# (YOLOv5's 80 COCO classes) and k cluster centres per class
CONCEPT_OBJECTS, CONCEPT_CLUSTERS = 80, 3


def write_explain_checkpoint(path: str, backbone: dict,
                             num_classes: int = EXPLAIN_CLASSES,
                             seed: int = 0) -> Dict[str, torch.Tensor]:
    """A Recognizer3D checkpoint of random f32 weights from a numpy seed
    (`models.recognizer.random_state_dict`) in the JAX package's format,
    config {"backbone", "num_classes"}; returns the state dict."""
    cfg = TimeSformerConfig(**backbone)
    sd = recognizer_state_dict(cfg, seed, num_classes=num_classes)
    save_checkpoint(path, recognizer_variables_to_jax(sd, cfg),
                    {"backbone": backbone, "num_classes": num_classes},
                    {"seed": seed})
    return sd


def write_concept_banks(path: str, dim: int, objects: int = CONCEPT_OBJECTS,
                        clusters: int = CONCEPT_CLUSTERS, seed: int = 0
                        ) -> Dict[str, tuple]:
    """The npz `cli.explain_demo.load_concept_banks` reads, drawn N(0, 1)
    from a numpy seed: 'symbolic' (objects, dim) named object{i}, and
    'cluster' (objects * clusters, dim) named object{i}#c{j}, as
    `explain.ctv.cluster_concept_vectors` names its centres.  Returns
    {level: (matrix, names)}."""
    rng = np.random.default_rng(seed)
    names = [f"object{i}" for i in range(objects)]
    banks = {
        "symbolic": (rng.standard_normal((objects, dim), np.float32), names),
        "cluster": (rng.standard_normal((objects * clusters, dim),
                                        np.float32),
                    [f"{n}#c{j}" for n in names for j in range(clusters)])}
    arrays = {}
    for level, (matrix, level_names) in banks.items():
        arrays[f"{level}_matrix"] = matrix
        arrays[f"{level}_names"] = np.array(level_names)
    np.savez(path, **arrays)
    return banks


def post_explain(port: int, payload: dict) -> float:
    """ms of one /explain request; an answer without a prediction
    raises."""
    ms, out = request(port, "explain", payload, timeout=600.0)
    if "prediction" not in out or not out.get("scores"):
        raise RuntimeError(f"explain answer without a prediction: {out}")
    return ms


def explain_phase_times(handler, rows, calls: int = 10, device=None
                        ) -> dict:
    """The two halves of a wave on rows (the pipeline's clips) already on
    the device, `calls` times: the capture forward (`capture_ms`) and the
    class-score gradient at the route's layer (`grad_ms`), by CUDA events
    on the card and the host clock on the CPU; the flash launches of one
    whole wave (`run_wave`) and, on the card, its peak memory
    (`peak_mb`, max_memory_allocated)."""
    from ..explain.grads import capture_forward, class_score_grads
    from ..ops.flash_attention import flash_attention
    device = device or next(handler.model.parameters()).device
    model, layer = handler.model, (handler.target_layer,)
    clips = torch.from_numpy(np.concatenate(rows)).to(device)
    cuda = device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(a, b):
        if not cuda:
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)

    scores, cls_idx, captured = capture_forward(model, clips, layer)
    class_score_grads(model, captured, cls_idx, layer)         # warm-up
    fwd, bwd = [], []
    for _ in range(calls):
        t0 = mark()
        scores, cls_idx, captured = capture_forward(model, clips, layer)
        t1 = mark()
        class_score_grads(model, captured, cls_idx, layer)
        t2 = mark()
        fwd.append(ms(t0, t1))
        bwd.append(ms(t1, t2))
    del scores, cls_idx, captured
    before = flash_attention.launches
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    handler.run_wave(clips).cpu()
    return {"capture_ms": float(np.mean(fwd)), "grad_ms": float(np.mean(bwd)),
            "phase_clock": "cuda events" if cuda else "host",
            "flash_launches": flash_attention.launches - before,
            "peak_mb": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                        if cuda else None)}


def run_explain(device=None, root: Optional[str] = None,
                backbone: Optional[dict] = None,
                num_classes: int = EXPLAIN_CLASSES, n_single: int = 32,
                burst: int = 8, wave_calls: int = 20, n_videos: int = 8,
                video_shape=(VIDEO_FRAMES, VIDEO_HEIGHT, VIDEO_WIDTH),
                seed: int = 0) -> List[dict]:
    device = resolve_device(device)
    backbone = backbone or CAPTION_BACKBONE
    out: List[dict] = []
    root = root or os.path.join(_REPO, "build")
    os.makedirs(root, exist_ok=True)
    frames, height, width = video_shape
    videos = seeded_videos(n_videos, seed + 1, frames=frames, height=height,
                           width=width)
    names = sorted(videos)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        # the grad probe's block: 10 of 12 (cli.serve's default)
        layer = get_model_layers("timesformer",
                                 backbone["num_layers"])["target"]
        args = argparse.Namespace(
            explain_checkpoint=os.path.join(tmp, "explain"),
            concept_banks=os.path.join(tmp, "banks.npz"),
            target_layer=layer, device=str(device))
        write_explain_checkpoint(args.explain_checkpoint, backbone,
                                 num_classes, seed)
        write_concept_banks(args.concept_banks, backbone["embed_dims"],
                            seed=seed + 2)
        server, handler = start_route_server(args, "explain",
                                             explain_decode=videos.__getitem__)
        try:
            port = server.server_address[1]
            base = {"video_frames": frames, "video_size": [height, width],
                    "attention_type": backbone["attention_type"],
                    "dtype": backbone.get("dtype", "float32"),
                    "layers": backbone["num_layers"],
                    "target_layer": handler.target_layer,
                    "classes": num_classes, **where(device)}
            payloads = [{"video": names[i % len(names)]}
                        for i in range(max(n_single, burst))]
            post_explain(port, payloads[0])                    # warm-up
            lat = [post_explain(port, p) for p in payloads[:n_single]]
            p = percentiles(lat)
            emit({"metric": "serve_explain_batch1", "value": p["p50"],
                  "unit": per("ms", device), "p99": p["p99"],
                  "n": len(lat), **base}, out)
            w0, r0 = handler.batcher.batches_run, handler.batcher.rows_run
            lat = clients_in_threads(port, payloads[:burst], burst,
                                      post_explain)
            waves = handler.batcher.batches_run - w0
            p = percentiles(lat)
            emit({"metric": f"serve_explain_burst{burst}", "value": p["p50"],
                  "unit": per("ms", device), "p99": p["p99"],
                  "n": len(lat), "waves": waves,
                  "rows_per_wave": (handler.batcher.rows_run - r0) / waves,
                  **base}, out)
            for n in (1, 8):
                rows = caption_wave_rows(handler, names, n)
                t = wave_times(handler, rows, wave_calls, device=device)
                t.update(explain_phase_times(handler, rows,
                                             max(wave_calls // 2, 1),
                                             device))
                emit({"metric": f"serve_explain_wave{n}",
                      "value": t["wall_ms"], "unit": per("ms", device),
                      **t, **base}, out)
            t = pipeline_times(handler, names)
            emit({"metric": "serve_explain_pipeline", "value": t["wall_ms"],
                  "unit": "ms/host", **t, **base}, out)
        finally:
            stop_server(server, handler)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--composed", action="store_true",
                    help="the composed-retrieval arm instead of LINAS")
    ap.add_argument("--caption", action="store_true",
                    help="the caption arm instead of LINAS")
    ap.add_argument("--explain", action="store_true",
                    help="the explain arm instead of LINAS")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--videos", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device")
    ap.add_argument("--root", default=None,
                    help="where the fixtures are written (a temporary "
                         "directory inside it; default: build/ of the "
                         "checkout)")
    args = ap.parse_args(argv)
    if args.composed:
        run_composed(args.videos, args.device, args.root)
    elif args.caption:
        run_caption(args.device, args.root)
    elif args.explain:
        run_explain(args.device, args.root)
    else:
        run(args.rows, args.videos, args.device, args.root)


if __name__ == "__main__":
    main()
