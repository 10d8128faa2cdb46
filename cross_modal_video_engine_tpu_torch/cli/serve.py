"""Engine HTTP server CLI: the four capability routes and the demo pages.

Counterpart of cross_modal_video_engine_tpu/cli/serve.py, on the CUDA
device (or `--device cpu`): text->video retrieval with the LINAS dual
encoder (`/retrieval`), label-sequence captions of a video with a
TimeSformer recognizer and its RNN decoder (`/caption`), composed
text+video retrieval with a CLIP tower and the Combiner
(`/composed_retrieval`), and explainable recognition with a TimeSformer
classifier, its gradient probe and concept banks (`/explain`).  Each
route is served when its checkpoints are given; `--demo` also serves the
static pages of service/demo/ (a page whose route is not served gets a
404 from the API).

  python -m cross_modal_video_engine_tpu_torch.cli.serve \
      --retrieval_checkpoint CKPT --rootpath R --collection C \
      --visual_feature F [--port 8765] [--device cpu]
  python -m cross_modal_video_engine_tpu_torch.cli.serve \
      --caption_checkpoint CKPT [--device cpu]
  python -m cross_modal_video_engine_tpu_torch.cli.serve \
      --clip_checkpoint CKPT --combiner_checkpoint CKPT2 \
      --videos_dir VIDEOS --merges merges.txt [--feature_cache DIR]
  python -m cross_modal_video_engine_tpu_torch.cli.serve \
      --explain_checkpoint CKPT [--concept_banks banks.npz] \
      [--target_layer 10] [--label_names names.json] [--demo]
"""

from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from ..service.app import DEMO_DIR, EngineService, create_server

# The smallest wave the retrieval route runs.  The JAX route pads waves to
# 8 rows because XLA lays a 1-row search out as a slow M=1 GEMV on the TPU.
# On the H100 the 1-row wave is the faster one (chip_smoke.py step 10 at
# 1M x 1536 f32 rows: 4.4 ms against 6.5 ms for 8 rows; cuBLAS's GEMV reads
# the rows near the memory rate, its 8-row GEMM does not; PERF.md), so
# waves are not padded up.  Results do not depend on it: padding repeats
# row 0.
RETRIEVAL_MIN_BATCH = 1


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
    max_batch = getattr(args, "max_batch", None) or 32
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


def build_caption_handler(args, decode=None):
    """The caption route: payload {"video", "threshold"} -> {"steps"}.

    The recognizer (`api.init_recognizer` on `args.caption_checkpoint`)
    goes to the device once, here.  A request decodes its video and runs
    the test pipeline (cli/caption_inference.DEFAULT_PIPELINE) on the host
    in the request's thread; `decode` (filename -> decord-alike reader,
    default io/video_decode.open_video) is handed to the pipeline's
    DecordInit.  A wave of requests (micro-batched, padded to a power of
    two by repeating row 0, at most `max_batch` = 8 rows) is one copy of
    the clips to the device, one `forward_test` and one fetch.  The
    handler carries `batcher`, `model`, `pipeline` and `run_wave(clips,
    num_segs)` (one wave on clips already on the device, returning the
    device tensor before the fetch) for measurement."""
    from ..api import init_recognizer, model_device
    from ..data.pipelines import build_pipeline, with_reader
    from ..service.batching import MicroBatcher
    from .caption_inference import DEFAULT_PIPELINE

    model, _ = init_recognizer(args.caption_checkpoint,
                               device=getattr(args, "device", None))
    device = model_device(model)
    pipe = build_pipeline(with_reader(DEFAULT_PIPELINE, decode))
    max_batch = getattr(args, "max_batch", None) or 8

    def run_wave(clips: torch.Tensor, num_segs: int) -> torch.Tensor:
        with torch.no_grad():
            return model.forward_test(clips, num_segs=num_segs)

    def model_rows(rows):
        # rows: (num_clips, T, H, W, C) float32 arrays of one shape
        num_segs = rows[0].shape[0]
        rows, n = _pow2_rows(rows, max_batch)
        clips = torch.from_numpy(np.concatenate(rows, axis=0)).to(device)
        probs = run_wave(clips, num_segs).cpu().numpy()    # the one fetch
        return [probs[i] for i in range(n)]

    batcher = MicroBatcher(model_rows, max_batch=max_batch,
                           max_wait_ms=getattr(args, "max_wait_ms", 5.0),
                           name="caption-model")

    def handler(payload: dict) -> dict:
        r = pipe({"filename": payload["video"], "start_index": 0})
        probs = batcher.submit(np.asarray(r["imgs"], np.float32))
        threshold = float(payload.get("threshold", 0.5))
        steps = [np.nonzero(p > threshold)[0] for p in probs]
        return {"steps": [[int(i) for i in s] for s in steps]}

    handler.batcher = batcher
    handler.model = model
    handler.pipeline = pipe
    handler.run_wave = run_wave
    return handler


def build_composed_handler(args, decode=None):
    """The composed-retrieval route (the inference.py:119-150 flow behind
    one POST): payload {"reference_video", "text", "topK"} ->
    {"results": names}.

    The CLIP tower, the Combiner and the candidate index (the videos of
    `args.videos_dir`, read from `args.feature_cache` where cached there)
    go to the device once, here; the index is frame-meaned and
    L2-normalized there once.  A request decodes its reference video with
    `decode(path)` (default: composed_inference.decode_video_frames,
    OpenCV) and encodes and pools it on the device in the request's
    thread, one request at a time.  A wave of requests (micro-batched,
    padded to a power of two by repeating row 0) is one `encode_text`, one
    `combine_features`, one product with the index and one fetch of the
    order.  The handler
    carries `batcher`, `names`, `clip_model`, `clip_cfg`, `combiner`,
    `tokenizer`, `reference_features(frames)` and `run_wave(highs,
    middles, ids)` (the wave's distances on the device, before the
    fetch) for measurement."""
    from ..service.batching import MicroBatcher
    from ..utils.bpe import BPETokenizer
    from .composed_inference import (build_combiner_inputs, candidate_index,
                                     decode_video_frames, encode_video_frames,
                                     load_clip_tower, load_combiner,
                                     normalized_index)

    decode = decode or decode_video_frames
    clip_model, clip_cfg = load_clip_tower(args.clip_checkpoint,
                                           getattr(args, "device", None))
    device = next(clip_model.parameters()).device
    combiner = load_combiner(args.combiner_checkpoint, device)
    tok = BPETokenizer(args.merges)
    dim = clip_cfg.image_resolution
    names, index_high = candidate_index(
        clip_model, dim, args.videos_dir,
        getattr(args, "feature_cache", None), decode)
    index = normalized_index(index_high)
    max_batch = getattr(args, "max_batch", None) or 8

    # one extraction enqueued at a time: the card runs them in turn
    # anyway, and the 64-frame activations of concurrent requests would
    # otherwise all be alive at once
    extract_lock = threading.Lock()

    def reference_features(frames_u8):
        with extract_lock:
            rh, rm = encode_video_frames(clip_model, frames_u8, dim)
            return build_combiner_inputs(rh, rm,
                                         dim=combiner.cfg.clip_feature_dim)

    def run_wave(highs, middles, ids) -> torch.Tensor:
        with torch.no_grad():
            text = clip_model.encode_text(ids).float()
            pred = combiner.combine_features((highs, middles), text)
            return 1.0 - pred @ index.t()

    def rank_rows(rows):
        # rows: [(ref_high (F, D), ref_middle (F, L, D), ids (1, S))]
        rows, n = _pow2_rows(rows, max_batch)
        ids = torch.from_numpy(np.concatenate([r[2] for r in rows])).to(
            device, torch.int64)
        dists = run_wave(torch.stack([r[0] for r in rows]),
                         torch.stack([r[1] for r in rows]), ids)
        order = torch.argsort(dists, dim=1).cpu().numpy()   # the one fetch
        return [order[i] for i in range(n)]

    batcher = MicroBatcher(rank_rows, max_batch=max_batch,
                           max_wait_ms=getattr(args, "max_wait_ms", 5.0),
                           name="composed-rank")

    def handler(payload: dict) -> dict:
        ref_high, ref_middle = reference_features(
            decode(payload["reference_video"]))
        ids = tok.tokenize(payload["text"], clip_cfg.context_length)
        order = batcher.submit((ref_high, ref_middle, ids))
        k = int(payload.get("topK", 1))
        return {"results": [names[i] for i in order[:k]]}

    handler.batcher = batcher
    handler.names = names
    handler.clip_model = clip_model
    handler.clip_cfg = clip_cfg
    handler.combiner = combiner
    handler.tokenizer = tok
    handler.reference_features = reference_features
    handler.run_wave = run_wave
    return handler


def build_explain_handler(args, decode=None):
    """The explain route (the inference_demo.py flow behind one POST):
    payload {"video", "target_layer", "topK"} -> {"prediction", "scores",
    "<level>_top"}.

    The classifier (`explain_demo.load_explain_model` on
    `args.explain_checkpoint`: a caption checkpoint is refused) goes to
    the device once, here; the concept banks (`args.concept_banks`) and
    label names stay on the host.  A request runs the test pipeline
    (cli/caption_inference.DEFAULT_PIPELINE) on the host in its own thread,
    `decode` handed to its DecordInit as in build_caption_handler.  At
    the default layer (`args.target_layer`) a wave of requests
    (micro-batched, padded to a power of two by repeating row 0, at most
    `max_batch` = 8 rows) is one copy of the clips to the device, the
    capture forward, the class-score gradient at that layer under grad
    mode (whatever the batcher's thread has set), and one fetch of the
    scores, the predicted classes and the CLS token's gradients; the
    concept scoring runs on the host.  A pad row adds to the summed class
    score, but a sample's gradient depends on no other sample.  A request
    that names another layer runs `explain_video` un-batched, one such
    request at a time (its graph spans every block above the layer).  The
    handler carries `batcher`, `model`, `pipeline`, `target_layer` and
    `run_wave(clips)` (one wave on clips already on the device, returning
    the packed device tensor before the fetch) for measurement."""
    import json
    from ..api import model_device
    from ..data.pipelines import build_pipeline, with_reader
    from ..explain.ctv import concept_scores, top_concepts
    from ..explain.grads import (capture_forward, class_score_grads,
                                 normalized_cls_grad)
    from ..explain.pipeline import explain_video
    from ..service.batching import MicroBatcher
    from . import caption_inference
    from .explain_demo import load_concept_banks, load_explain_model

    model, _ = load_explain_model(args.explain_checkpoint,
                                  getattr(args, "device", None))
    device = model_device(model)
    concept_banks = getattr(args, "concept_banks", None)
    banks = load_concept_banks(concept_banks) if concept_banks else {}
    label_names = None
    if getattr(args, "label_names", None):
        with open(args.label_names) as f:
            label_names = json.load(f)
    pipe = build_pipeline(with_reader(caption_inference.DEFAULT_PIPELINE,
                                      decode))
    max_batch = getattr(args, "max_batch", None) or 8
    default_layer = getattr(args, "target_layer", 10)
    classes = model.cls_head.fc_cls.out_features
    custom_lock = threading.Lock()

    def run_wave(clips: torch.Tensor) -> torch.Tensor:
        """(rows, C + 1 + D) f32 on the device: the class scores, the
        target class, the gradient at the CLS token after block
        default_layer."""
        scores, cls_idx, captured = capture_forward(model, clips,
                                                    (default_layer,))
        grads = class_score_grads(model, captured, cls_idx,
                                  (default_layer,))
        return torch.cat([scores.float(), cls_idx[:, None].float(),
                          grads[default_layer][:, 0]], dim=1)

    def grad_rows(rows):
        # rows: (num_clips, T, H, W, C) float32 arrays of one shape; a
        # request's probe is the mean over its own clips' rows
        k = rows[0].shape[0]
        rows, n = _pow2_rows(rows, max_batch)
        clips = torch.from_numpy(np.concatenate(rows, axis=0)).to(device)
        packed = run_wave(clips).cpu().numpy()             # the one fetch
        scores = packed[:, :classes]
        preds = packed[:, classes].astype(np.int64)
        cls_grads = packed[:, classes + 1:]
        return [dict(pred=preds[i * k:(i + 1) * k],
                     scores=scores[i * k:(i + 1) * k],
                     grad_probe=normalized_cls_grad(
                         cls_grads[i * k:(i + 1) * k, None]))
                for i in range(n)]

    batcher = MicroBatcher(grad_rows, max_batch=max_batch,
                           max_wait_ms=getattr(args, "max_wait_ms", 5.0),
                           name="explain-grad")

    def handler(payload: dict) -> dict:
        r = pipe({"filename": payload["video"], "start_index": 0})
        clips = np.asarray(r["imgs"], np.float32)
        layer = int(payload.get("target_layer", default_layer))
        topk = int(payload.get("topK", 5))
        if layer == default_layer:
            out = batcher.submit(clips)
            for level, bank in banks.items():
                s = concept_scores(bank.matrix, out["grad_probe"])
                out[f"{level}_top"] = top_concepts(s, bank.names, topk)
        else:       # another layer: the un-batched path
            with custom_lock:
                out = explain_video(model, clips, target_layer=layer,
                                    concept_banks=banks, topk=topk)
        pred = int(out["pred"][0])
        resp = {
            "prediction": label_names[pred] if label_names else pred,
            "scores": [float(s) for s in np.asarray(out["scores"][0])],
        }
        for level in banks:
            resp[f"{level}_top"] = [
                {"concept": n, "score": float(s)}
                for n, s in out[f"{level}_top"]]
        return resp

    handler.batcher = batcher
    handler.model = model
    handler.pipeline = pipe
    handler.target_layer = default_layer
    handler.run_wave = run_wave
    return handler


def build_service(args, decode=None, caption_decode=None,
                  explain_decode=None) -> EngineService:
    """Register the retrieval, caption and explain routes if their
    checkpoints were given, and the composed-retrieval route if both of
    its checkpoints were (`decode`: see build_composed_handler;
    `caption_decode` and `explain_decode`: the `decode` of
    build_caption_handler and build_explain_handler)."""
    service = EngineService()
    if getattr(args, "retrieval_checkpoint", None):
        service.register("retrieval", build_retrieval_handler(args))
    if getattr(args, "caption_checkpoint", None):
        service.register("caption",
                         build_caption_handler(args, caption_decode))
    if (getattr(args, "clip_checkpoint", None)
            and getattr(args, "combiner_checkpoint", None)):
        service.register("composed_retrieval",
                         build_composed_handler(args, decode))
    if getattr(args, "explain_checkpoint", None):
        service.register("explain",
                         build_explain_handler(args, explain_decode))
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
    parser.add_argument("--max_batch", type=int, default=None,
                        help="rows a wave may hold (default: 32 for "
                             "retrieval, 8 for captions, composed "
                             "retrieval and explain)")
    # captions
    parser.add_argument("--caption_checkpoint")
    # composed retrieval
    parser.add_argument("--clip_checkpoint")
    parser.add_argument("--combiner_checkpoint")
    parser.add_argument("--videos_dir")
    parser.add_argument("--merges")
    parser.add_argument("--feature_cache", default=None,
                        help="per-video npz cache dir shared with "
                             "composed_inference (skips re-encoding "
                             "the corpus on restart)")
    # explain
    parser.add_argument("--explain_checkpoint")
    parser.add_argument("--concept_banks", default=None,
                        help="npz of {level}_matrix / {level}_names")
    parser.add_argument("--target_layer", type=int, default=10,
                        help="the block whose gradient the batched waves "
                             "probe; a request may name another")
    parser.add_argument("--label_names", default=None,
                        help="json list of class names")
    parser.add_argument("--demo", action="store_true",
                        help="also serve the static demo pages at /demo")
    args = parser.parse_args(argv)

    service = build_service(args)
    server = create_server(service, args.host, args.port,
                           demo_dir=DEMO_DIR if args.demo else None)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"routes={sorted(service.handlers)}"
          + (" demo=/demo" if args.demo else ""), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
