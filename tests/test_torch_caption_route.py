"""The port's /caption route against the JAX package's, on the CPU at a
small size (2 layers, width 64, 4 heads, 8x32² clips, 5 classes), from a
checkpoint the JAX package wrote: the port's server over real HTTP
answers as JAX's `build_caption_handler` does, alone and in a burst of
concurrent requests; the `decode` seam (a decord-alike reader) gives the
answers the video file gives; a wave pads to a power of two and answers
each row as the row alone; `cli.serve` registers the route; and the
caption arm of bench/serve.py runs tiny on the CPU.

The JAX flash kernel runs in interpret mode, the port's flash attention
its plain version.  Answers (thresholded label sequences) are compared
for equality: the checkpoint's seed leaves every probability at least
1e-3 from the threshold (test_torch_caption_api.py asserts it on these
videos), and f32 agrees within 1e-4."""

import argparse
import json
import threading

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import caption_inference as jci
from cross_modal_video_engine_tpu.cli import serve as jserve
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.bench import serve as bserve
from cross_modal_video_engine_tpu_torch.cli import caption_inference as tci
from cross_modal_video_engine_tpu_torch.cli import serve as tserve
from cross_modal_video_engine_tpu_torch.io import video_decode as tvd
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    random_state_dict)
from cross_modal_video_engine_tpu_torch.models.timesformer import (
    TimeSformerConfig)
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.service.app import create_server
from test_torch_caption_api import (DEC, PIPE, TS, jax_caption_checkpoint,
                                    write_videos)
from torch_parity import interpret_pallas

SHIPPED_PIPELINE = tci.DEFAULT_PIPELINE


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tiny_pipeline(monkeypatch):
    """Both routes read caption_inference.DEFAULT_PIPELINE when built."""
    monkeypatch.setattr(jci, "DEFAULT_PIPELINE", PIPE)
    monkeypatch.setattr(tci, "DEFAULT_PIPELINE", PIPE)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("route"))
    videos = write_videos(root, 4)
    ckpt = root + "/ckpt"
    jax_caption_checkpoint(ckpt)
    return videos, ckpt


def _serve(ckpt, decode=None, max_batch=None):
    args = argparse.Namespace(caption_checkpoint=ckpt, device="cpu",
                              max_batch=max_batch)
    service = tserve.build_service(args, caption_decode=decode)
    server = create_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service.handlers["caption"]


def _stop(server, handler):
    server.shutdown()
    server.server_close()
    handler.batcher.close()


def _post(port, payload):
    return bserve.request(port, "caption", payload)[1]


def test_route_over_http_answers_as_the_jax_handler(world):
    videos, ckpt = world
    jh = jserve.build_caption_handler(argparse.Namespace(
        caption_checkpoint=ckpt))
    server, handler = _serve(ckpt)
    try:
        port = server.server_address[1]
        for video in videos:
            for threshold in (0.5, 0.45):
                payload = {"video": video, "threshold": threshold}
                got = _post(port, payload)
                assert got == jh(payload)
                assert len(got["steps"]) == DEC["max_len"]
        # the threshold defaults to 0.5, as in JAX
        assert _post(port, {"video": videos[0]}) == jh({"video": videos[0]})
        assert handler.batcher.rows_run == 9
    finally:
        _stop(server, handler)
        jh.batcher.close()


def test_burst_of_concurrent_requests_answers_each_alone(world):
    """Eight requests at once (waves of up to 8 rows, padded to a power of
    two) give each video the answer it gets alone."""
    videos, ckpt = world
    server, handler = _serve(ckpt)
    try:
        port = server.server_address[1]
        alone = {v: _post(port, {"video": v}) for v in videos}
        payloads = [{"video": videos[i % 4]} for i in range(8)]
        answers = [None] * 8
        barrier = threading.Barrier(8)

        def client(i):
            barrier.wait()
            answers[i] = _post(port, payloads[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        w0 = handler.batcher.batches_run
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert handler.batcher.batches_run - w0 <= 8
        assert answers == [alone[p["video"]] for p in payloads]
    finally:
        _stop(server, handler)


def test_wave_pads_to_a_power_of_two(world):
    videos, ckpt = world
    server, handler = _serve(ckpt)
    try:
        rows = [api.run_pipeline(PIPE, v) for v in videos[:3]]
        got = handler.batcher.fn(rows)            # 3 rows, run as 4
        assert len(got) == 3
        for row, probs in zip(rows, got):
            _, want = api.caption_clips(handler.model, torch.from_numpy(row))
            np.testing.assert_allclose(probs, want[0].numpy(), rtol=0,
                                       atol=1e-5)
        out = handler.run_wave(torch.from_numpy(np.concatenate(rows)), 2)
        assert out.shape == (3, DEC["max_len"], DEC["num_classes"])
    finally:
        _stop(server, handler)


def test_decode_seam_gives_the_files_answers(world):
    """A decord-alike reader handed through `caption_decode` (no file is
    opened) gives the answers the files give."""
    videos, ckpt = world
    frames = {}
    for v in videos:
        r = tvd.open_video(v)
        frames[v] = r.get_batch(np.arange(len(r)))
        r.release()
    opened = []

    class Reader:
        def __init__(self, name):
            opened.append(name)
            self.frames, self.fps = frames[name], 10.0

        def __len__(self):
            return len(self.frames)

        def get_batch(self, idx):
            return self.frames[np.asarray(idx)]

        def release(self):
            pass

    file_server, file_handler = _serve(ckpt)
    seam_server, seam_handler = _serve(ckpt, decode=Reader)
    try:
        for v in videos:
            want = _post(file_server.server_address[1], {"video": v})
            assert _post(seam_server.server_address[1], {"video": v}) == want
        assert opened == list(videos)
    finally:
        _stop(file_server, file_handler)
        _stop(seam_server, seam_handler)


def test_serve_cli_registers_the_caption_route(world, monkeypatch):
    _, ckpt = world
    args = argparse.Namespace(caption_checkpoint=ckpt, device="cpu")
    service = tserve.build_service(args)
    assert sorted(service.handlers) == ["caption"]
    service.handlers["caption"].batcher.close()
    built = {}

    def fake_create_server(service, host, port, demo_dir=None):
        built.update(service=service, host=host, port=port,
                     demo_dir=demo_dir)
        raise KeyboardInterrupt            # stop before serving

    monkeypatch.setattr(tserve, "create_server", fake_create_server)
    with pytest.raises(KeyboardInterrupt):
        tserve.main(["--caption_checkpoint", ckpt, "--device", "cpu",
                     "--port", "0"])
    assert sorted(built["service"].handlers) == ["caption"]
    built["service"].handlers["caption"].batcher.close()
    assert built["demo_dir"] is None           # no --demo


def test_caption_serving_bench_runs_on_the_cpu(tmp_path, capsys,
                                              monkeypatch):
    """The bench's route runs the shipped test pipeline (224² crops), so
    the model is 224² at patch 56 (16 patches a frame)."""
    monkeypatch.setattr(tci, "DEFAULT_PIPELINE", SHIPPED_PIPELINE)
    backbone = dict(TS, img_size=224, patch_size=56)
    rows = bserve.run_caption(device="cpu", root=str(tmp_path),
                              backbone=backbone, decoder=DEC, n_single=3,
                              clients=3, per_client=1, wave_calls=2,
                              n_videos=2, video_shape=(40, 36, 48))
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    metrics = [r["metric"] for r in rows]
    assert metrics == ["serve_caption_batch1", "serve_caption_conc3",
                       "serve_caption_wave1", "serve_caption_wave8",
                       "serve_caption_pipeline"]
    assert [r["metric"] for r in printed] == metrics
    for r in rows:
        assert r["device"] == "cpu" and np.isfinite(r["value"])
        assert r["unit"] in ("ms/cpu", "ms/host")
    assert rows[0]["n"] == 3 and rows[1]["n"] == 3
    assert rows[3]["wave_rows"] == 8 and rows[2]["events_ms"] is None
    assert list(tmp_path.iterdir()) == []          # fixtures removed


def test_seeded_video_and_checkpoint(tmp_path):
    """SeededVideo draws the same frame for the same (seed, index), a
    decord-alike; the caption checkpoint it serves is the seeded state
    dict in the JAX format."""
    a, b = bserve.SeededVideo(4, 10, 12, 16), bserve.SeededVideo(4, 10, 12,
                                                                 16)
    assert len(a) == 10 and a.fps == 30.0
    got = a.get_batch([3, 1, 3])
    assert got.shape == (3, 12, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, b.get_batch([3, 1, 3]))
    np.testing.assert_array_equal(got[0], got[2])
    assert not np.array_equal(got[0], got[1])
    assert not np.array_equal(got[0], bserve.SeededVideo(5, 10, 12, 16)
                              .frame(3))
    sd = bserve.write_caption_checkpoint(str(tmp_path / "c"), TS, DEC, 3)
    want = random_state_dict(TimeSformerConfig(**TS), 3,
                             decoder_cfg=RNNDecoderConfig(**DEC))
    model, _ = api.init_recognizer(str(tmp_path / "c"), device="cpu")
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]) and torch.equal(t, want[k]), k
    assert bserve.shipped_caption_model()["decoder"] == dict(
        num_classes=36, in_channels=768, max_len=5, threshold=0.5)


def test_caption_checkpoint_logit_scale(tmp_path):
    """logit_scale multiplies the decoder's output layer and nothing else,
    so the step logits grow by that factor."""
    base = bserve.write_caption_checkpoint(str(tmp_path / "a"), TS, DEC, 3)
    scaled = bserve.write_caption_checkpoint(str(tmp_path / "b"), TS, DEC, 3,
                                             logit_scale=16.0)
    model, _ = api.init_recognizer(str(tmp_path / "b"), device="cpu")
    for k, t in model.state_dict().items():
        want = base[k] * 16.0 if k.startswith("cls_head.out.") else base[k]
        assert torch.equal(t, scaled[k]) and torch.equal(t, want), k
    assert sum(k.startswith("cls_head.out.") for k in base) == 2


@pytest.mark.parametrize("clients", [1, 3, 8])
def test_clients_in_threads_answers_in_payload_order(clients):
    """Every payload is posted once, from `clients` threads started
    together, and its answer stands at the payload's place."""
    seen, lock = [], threading.Lock()

    def post(port, payload):
        with lock:
            seen.append((port, threading.get_ident()))
        return payload["i"] * 10

    payloads = [{"i": i} for i in range(8)]
    got = bserve.clients_in_threads(7, payloads, clients, post)
    assert got == [i * 10 for i in range(8)]
    assert len(seen) == 8 and {p for p, _ in seen} == {7}
    assert len({t for _, t in seen}) == clients


def test_clients_in_threads_raises_on_a_failed_post():
    def post(port, payload):
        if payload["i"] == 2:
            raise ValueError("refused")
        return payload["i"]

    with pytest.raises(RuntimeError, match="refused"):
        bserve.clients_in_threads(0, [{"i": i} for i in range(4)], 2, post)
