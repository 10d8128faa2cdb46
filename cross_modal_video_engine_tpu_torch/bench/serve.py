"""LINAS text->video retrieval served over HTTP: latency at 1M rows.

    python -m cross_modal_video_engine_tpu_torch.bench.serve \
        [--rows 1000000] [--videos 1000] [--device cpu]

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

from ..convert.from_jax import dual_encoding_variables_to_jax
from ..io.bigfile import write_bigfile
from ..models.dual_encoding import DualEncodingConfig, seeded_state_dict
from ..train.checkpoint import save_checkpoint
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


def wave_times(handler, rows, calls: int = 50) -> dict:
    """One wave of `rows`, as the batcher runs it (text batch to the
    device, text tower, search, one fetch), `calls` times: wall ms per
    wave (host clock), the card's span of a wave by CUDA events (from the
    first enqueue to the last kernel's end), the kernels' busy ms a wave
    (torch.profiler) with the six longest kernels, and the idle share
    1 - busy / wall.  On the CPU only the wall is measured."""
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
    if handler.model.device.type != "cuda":
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run(rows)
        torch.cuda.synchronize()
    # device entries only: aten entries carry their kernels' time too
    kernels = sorted(((e.self_device_time_total / calls / 1e3, e.key)
                      for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")), reverse=True)
    busy = sum(ms for ms, _ in kernels)
    out.update(events_ms=float(np.mean(spans)), busy_ms=busy,
               idle_share=1.0 - busy / wall,
               top_kernels=[[key[:80], ms] for ms, key in kernels[:6]])
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--videos", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device")
    ap.add_argument("--root", default=None,
                    help="where the fixtures are written (a temporary "
                         "directory inside it; default: build/ of the "
                         "checkout)")
    args = ap.parse_args(argv)
    run(args.rows, args.videos, args.device, args.root)


if __name__ == "__main__":
    main()
