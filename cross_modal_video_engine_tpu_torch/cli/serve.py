"""Engine HTTP server CLI, retrieval route.

Counterpart of cross_modal_video_engine_tpu/cli/serve.py for the route
ported so far: text->video retrieval with the LINAS dual encoder on the
CUDA device (or `--device cpu`).  The caption, composed-retrieval and
explain routes and the demo pages are not ported yet; their flags raise
and name the ROADMAP.md item that ports them.

  python -m cross_modal_video_engine_tpu_torch.cli.serve \
      --retrieval_checkpoint CKPT --rootpath R --collection C \
      --visual_feature F [--port 8765] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..service.app import EngineService, create_server

# The smallest wave the retrieval route runs.  The JAX route pads waves to
# 8 rows because XLA lays a 1-row search out as a slow M=1 GEMV on the TPU.
# On the H100 the 1-row wave is the faster one (chip_smoke.py step 10 at
# 1M x 1536 f32 rows: 4.4 ms against 6.5 ms for 8 rows; cuBLAS's GEMV reads
# the rows near the memory rate, its 8-row GEMM does not; PERF.md), so
# waves are not padded up.  Results do not depend on it: padding repeats
# row 0.
RETRIEVAL_MIN_BATCH = 1

# the routes of the JAX server that the port does not serve yet
NOT_PORTED = {
    "caption_checkpoint": "the caption route (ROADMAP.md queue 1 item 6)",
    "clip_checkpoint": "the composed retrieval route (ROADMAP.md queue 1 "
                       "item 5)",
    "combiner_checkpoint": "the composed retrieval route (ROADMAP.md queue 1 "
                           "item 5)",
    "explain_checkpoint": "the explain route (ROADMAP.md queue 1 item 7)",
    "demo": "the demo pages (ROADMAP.md queue 1 item 4)",
}


def _pow2_rows(rows, max_batch, min_batch=1):
    """Pad a request wave to the next power of two (>= min_batch) by
    repeating row 0, so a wave has one of log2(max_batch)+1 sizes.
    Returns (rows, n_real)."""
    from ..service.batching import _pad_pow2
    n = len(rows)
    padded = _pad_pow2(max(n, min_batch), max(n, max_batch, min_batch))
    return list(rows) + [rows[0]] * (padded - n), n


def wave_k(ks, n_active: int) -> int:
    """The k a wave searches with: the largest k asked for, as a power of
    two of at least 16, capped at the live rows (serve.py:92-94 of the
    JAX route)."""
    k = max(16, 1 << (max(ks) - 1).bit_length())
    return min(k, n_active)


def build_retrieval_handler(args):
    """The retrieval route: payload {"query", "topK"} -> {"results"}.

    The model's parameters go to the device once, here.  A wave of
    requests (micro-batched) is one pass on the device: the student text
    tower (`embed_txt_distill`), L2 normalization, the index search, and
    one fetch of the scores with the ids bit-cast beside them.  The
    text GRU's lengths also go to the host once a wave, for packing,
    before any of the wave's work is enqueued.  The handler carries
    `batcher`, `index`, `dataset`, `model` and `run_wave(batch, k)` (one
    wave on a built TextBatch, returning the device tensor before the
    fetch) for measurement."""
    from ..models.dual_encoding import make_text_batch
    from ..service.batching import MicroBatcher
    from .common import load_dataset, restore_dual_encoding
    from .retrieval_inference import build_video_index

    model, _ = restore_dual_encoding(args.retrieval_checkpoint,
                                     device=getattr(args, "device", None))
    dataset = load_dataset(args.rootpath, args.collection,
                           args.visual_feature, device=model.device)
    index = build_video_index(model, dataset,
                              cache=getattr(args, "index_cache", None),
                              dtype=getattr(args, "index_dtype", None),
                              capacity=getattr(args, "index_capacity", None))
    max_batch = getattr(args, "max_batch", 32)
    search = index.searcher()

    def run_wave(batch, k: int) -> torch.Tensor:
        """(rows, 2k) f32 on the device: scores, then the int32 row
        indices bit-cast to f32."""
        with torch.no_grad():
            q = model.embed_txt_distill(batch)
            qn = q / torch.clamp_min(
                torch.linalg.norm(q, dim=1, keepdim=True), 1e-12)
            vals, idx = search(index.emb, index.scales, index.valid, qn, k)
            return torch.cat([vals, idx.to(torch.int32).view(torch.float32)],
                             dim=1)

    def query_rows(rows):
        # rows: [(ids, bow, k)]; make_text_batch pads to max_words, so the
        # shapes depend only on the pow2-padded wave size
        rows, n = _pow2_rows(rows, max_batch, RETRIEVAL_MIN_BATCH)
        batch = make_text_batch(
            [ids[: dataset.max_words] for ids, _, _ in rows],
            np.stack([bow for _, bow, _ in rows]), dataset.max_words,
            device=model.device)
        k = wave_k([k for _, _, k in rows[:n]], index.n_active)
        packed = run_wave(batch, k).cpu().numpy()      # the one fetch
        scores = packed[:, :k]
        idx = np.ascontiguousarray(packed[:, k:]).view(np.int32)
        ids_out = [[index.ids[j] for j in row] for row in idx]
        return [(scores[i], ids_out[i]) for i in range(n)]

    batcher = MicroBatcher(query_rows, max_batch=max_batch,
                           max_wait_ms=getattr(args, "max_wait_ms", 5.0),
                           name="retrieval-query")

    def handler(payload: dict) -> dict:
        bow, ids = dataset.process_cap(payload["query"])
        k = int(payload.get("topK", 10))
        scores, vids = batcher.submit((ids, bow, k))
        return {"results": [
            {"video": v, "score": float(s)}
            for v, s in zip(vids[:k], scores[:k])]}

    handler.batcher = batcher
    handler.index = index
    handler.dataset = dataset
    handler.model = model
    handler.run_wave = run_wave
    return handler


def build_service(args) -> EngineService:
    """Register the retrieval route if its checkpoint was given; a flag of
    a route that is not ported yet raises."""
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag}: {what} is not ported to the PyTorch package yet")
    service = EngineService()
    if getattr(args, "retrieval_checkpoint", None):
        service.register("retrieval", build_retrieval_handler(args))
    return service


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    parser.add_argument("--retrieval_checkpoint")
    parser.add_argument("--rootpath")
    parser.add_argument("--collection")
    parser.add_argument("--visual_feature")
    parser.add_argument("--index_cache", default=None)
    parser.add_argument("--index_dtype", default=None,
                        choices=("float32", "bfloat16", "int8"),
                        help="stored-row precision; bfloat16/int8 are the "
                             "low-memory serving modes (int8 trades "
                             "exactness for bandwidth)")
    parser.add_argument("--index_capacity", type=int, default=None,
                        help="index slot count (default 2x rows for "
                             "incremental-add headroom; set to the row "
                             "count for a frozen corpus to halve the "
                             "index's memory)")
    # routes of the JAX server that are not ported yet: they raise
    parser.add_argument("--caption_checkpoint")
    parser.add_argument("--clip_checkpoint")
    parser.add_argument("--combiner_checkpoint")
    parser.add_argument("--explain_checkpoint")
    parser.add_argument("--demo", action="store_true")
    args = parser.parse_args(argv)

    service = build_service(args)
    server = create_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"routes={sorted(service.handlers)}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
