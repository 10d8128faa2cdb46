"""The port's explain CLI, /explain route, demo pages and explain bench
arm against the JAX package's, on the CPU at a small size (8 frames of
32², patch 8, width 64, 4 heads, 3 layers, 5 classes, f32, flash on; the
probe at block 1), from checkpoints the JAX package wrote and videos
written with OpenCV: `cli.explain_demo` answers as JAX's CLI does; the
port's server over real HTTP answers as JAX's `build_explain_handler`
does at the default layer and at another, alone and in a burst; a wave
pads to a power of two, answers each row as the row alone and takes its
gradient whatever the caller's grad mode; the `decode` seam gives the
files' answers; a caption checkpoint is refused; `cli.serve` registers
the route and serves the seven demo pages, byte for byte JAX's, where an
unregistered route gets a 404; and the explain arm of bench/serve.py
runs tiny on the CPU.

The JAX flash kernel runs in interpret mode, the port's flash attention
its plain version.  Tolerances: class scores within 1e-5; concept scores
within 1e-4 of their largest magnitude (they are products with the
normalized gradient); labels and concept names equal."""

import argparse
import json
import os
import threading
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import caption_inference as jci
from cross_modal_video_engine_tpu.cli import explain_demo as jdemo
from cross_modal_video_engine_tpu.cli import serve as jserve
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.service.app import DEMO_DIR as JAX_DEMO_DIR
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.bench import serve as bserve
from cross_modal_video_engine_tpu_torch.cli import caption_inference as tci
from cross_modal_video_engine_tpu_torch.cli import explain_demo as tdemo
from cross_modal_video_engine_tpu_torch.cli import serve as tserve
from cross_modal_video_engine_tpu_torch.explain.grads import (
    grad_extract, normalized_cls_grad)
from cross_modal_video_engine_tpu_torch.io import video_decode as tvd
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    random_state_dict)
from cross_modal_video_engine_tpu_torch.models.timesformer import (
    TimeSformerConfig)
from cross_modal_video_engine_tpu_torch.service.app import (DEMO_DIR,
                                                            create_server)
from test_torch_caption_api import (PIPE, TS, jax_caption_checkpoint,
                                    write_videos)
from torch_parity import interpret_pallas, random_variables

SHIPPED_PIPELINE = tci.DEFAULT_PIPELINE
BACKBONE = dict(TS, num_layers=3)
CLASSES, LAYER, TOL, REL = 5, 1, 1e-5, 1e-4
DEMO_FILES = sorted(os.listdir(JAX_DEMO_DIR))


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
    """The routes read caption_inference.DEFAULT_PIPELINE when built, the
    CLIs explain_demo.DEFAULT_PIPELINE when run."""
    for module in (jci, tci, jdemo, tdemo):
        monkeypatch.setattr(module, "DEFAULT_PIPELINE", PIPE)


def jax_explain_checkpoint(path, seed=21):
    """A Recognizer3D checkpoint the JAX package writes, of random weights
    from a numpy seed."""
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**BACKBONE),
                           num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32)), seed)
    jax_save_checkpoint(path, variables, {"backbone": dict(BACKBONE),
                                          "num_classes": CLASSES})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("explain"))
    videos = write_videos(root, 4, seed=8)
    ckpt = os.path.join(root, "ckpt")
    jax_explain_checkpoint(ckpt)
    banks = os.path.join(root, "banks.npz")
    bserve.write_concept_banks(banks, BACKBONE["embed_dims"], objects=6,
                               clusters=2, seed=3)
    names = os.path.join(root, "names.json")
    with open(names, "w") as f:
        json.dump([f"label{i}" for i in range(CLASSES)], f)
    caption = os.path.join(root, "caption")
    jax_caption_checkpoint(caption)
    return dict(videos=videos, ckpt=ckpt, banks=banks, names=names,
                caption=caption)


def _args(world, **kw):
    return argparse.Namespace(**{
        "explain_checkpoint": world["ckpt"], "concept_banks": world["banks"],
        "label_names": world["names"], "target_layer": LAYER,
        "device": "cpu", **kw})


def _serve(world, decode=None, demo_dir=None, **kw):
    service = tserve.build_service(_args(world, **kw), explain_decode=decode)
    server = create_server(service, "127.0.0.1", 0, demo_dir=demo_dir)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service.handlers["explain"]


def _stop(server, handler):
    server.shutdown()
    server.server_close()
    handler.batcher.close()


def _post(port, payload):
    return bserve.request(port, "explain", payload)[1]


def _same_answer(got, want):
    assert sorted(got) == sorted(want)
    assert got["prediction"] == want["prediction"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=TOL)
    for key in want:
        if key.endswith("_top"):
            assert ([c["concept"] for c in got[key]]
                    == [c["concept"] for c in want[key]])
            w = np.asarray([c["score"] for c in want[key]])
            np.testing.assert_allclose([c["score"] for c in got[key]], w,
                                       rtol=0, atol=REL * np.abs(w).max())


# -- the CLI -------------------------------------------------------------------------

def test_explain_cli_matches_the_jax_cli(world, capsys):
    argv = ["--checkpoint", world["ckpt"], "--target_video_path",
            world["videos"][1], "--concept_banks", world["banks"],
            "--target_layer", str(LAYER), "--topk", "3", "--label_names",
            world["names"]]
    want = jdemo.main(argv)
    jax_out = capsys.readouterr().out.splitlines()
    got = tdemo.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got["grad_probe"], want["grad_probe"],
                               rtol=0, atol=REL)
    for level in ("symbolic", "cluster"):
        assert ([n for n, _ in got[f"{level}_top"]]
                == [n for n, _ in want[f"{level}_top"]])
        assert len(got[f"{level}_top"]) == 3
    # the same report: prediction, levels and concepts in order
    assert out[0] == jax_out[0] and out[0].startswith("prediction: label")
    assert ([line.split("\t")[0] for line in out]
            == [line.split("\t")[0] for line in jax_out])


def test_explain_cli_without_banks_prints_the_class_index(world, capsys):
    argv = ["--checkpoint", world["ckpt"], "--target_video_path",
            world["videos"][0], "--target_layer", "0"]
    want = jdemo.main(argv)
    capsys.readouterr()
    got = tdemo.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == f"prediction: {int(want['pred'][0])}\n"
    np.testing.assert_allclose(got["grad_probe"], want["grad_probe"],
                               rtol=0, atol=REL)


def test_load_concept_banks_matches_jax(world):
    got, want = (tdemo.load_concept_banks(world["banks"]),
                 jdemo.load_concept_banks(world["banks"]))
    assert sorted(got) == sorted(want) == ["cluster", "symbolic"]
    for level, bank in want.items():
        assert got[level].names == bank.names
        np.testing.assert_array_equal(got[level].matrix, bank.matrix)
        assert got[level].matrix.dtype == np.float32
    assert got["cluster"].names[:3] == ["object0#c0", "object0#c1",
                                        "object1#c0"]


def test_a_caption_checkpoint_is_refused(world):
    """The explain entry points need a classifier: a checkpoint whose
    config has a decoder is refused before any gradient is asked of it."""
    with pytest.raises(ValueError, match="classification checkpoint"):
        tdemo.main(["--checkpoint", world["caption"], "--target_video_path",
                    world["videos"][0], "--device", "cpu"])
    with pytest.raises(ValueError, match="classification checkpoint"):
        tserve.build_service(argparse.Namespace(
            explain_checkpoint=world["caption"], device="cpu"))


# -- the route ---------------------------------------------------------------------------

def test_route_over_http_answers_as_the_jax_handler(world):
    jh = jserve.build_explain_handler(_args(world))
    server, handler = _serve(world)
    try:
        port = server.server_address[1]
        for video in world["videos"]:
            for extra in ({}, {"topK": 2}, {"target_layer": 0, "topK": 3}):
                payload = {"video": video, **extra}
                got = _post(port, payload)
                _same_answer(got, jh(payload))
                assert len(got["scores"]) == CLASSES
                assert len(got["symbolic_top"]) == extra.get("topK", 5)
        # the custom layer takes the un-batched path
        assert handler.batcher.rows_run == 8
    finally:
        _stop(server, handler)
        jh.batcher.close()


def test_burst_of_concurrent_requests_answers_each_alone(world):
    server, handler = _serve(world)
    try:
        port = server.server_address[1]
        alone = {v: _post(port, {"video": v}) for v in world["videos"]}
        payloads = [{"video": world["videos"][i % 4]} for i in range(8)]
        w0 = handler.batcher.batches_run
        answers = bserve.clients_in_threads(port, payloads, 8, _post)
        assert handler.batcher.batches_run - w0 <= 8
        for payload, got in zip(payloads, answers):
            _same_answer(got, alone[payload["video"]])
    finally:
        _stop(server, handler)


def test_wave_pads_and_takes_its_gradient_under_any_grad_mode(world):
    """3 rows run as 4 (row 0 repeated); each answers as it does alone,
    also when the calling thread has grad mode off."""
    server, handler = _serve(world)
    try:
        rows = [api.run_pipeline(PIPE, v) for v in world["videos"][:3]]
        alone = [handler.batcher.fn([r])[0] for r in rows]
        with torch.no_grad():
            waves = [handler.batcher.fn(rows)]
        waves.append(handler.batcher.fn(rows))
        for got in waves:
            assert len(got) == 3
            for g, a in zip(got, alone):
                np.testing.assert_array_equal(g["pred"], a["pred"])
                np.testing.assert_allclose(g["scores"], a["scores"], rtol=0,
                                           atol=TOL)
                np.testing.assert_allclose(g["grad_probe"], a["grad_probe"],
                                           rtol=0, atol=REL)
        clips = torch.from_numpy(np.concatenate(rows))
        packed = handler.run_wave(clips)
        k = rows[0].shape[0]
        assert packed.shape == (3 * k, CLASSES + 1 + BACKBONE["embed_dims"])
        assert handler.target_layer == LAYER
        # the packed gradient is the CLS row of grad_extract's
        g = grad_extract(handler.model, clips[:k], [LAYER])
        np.testing.assert_allclose(
            normalized_cls_grad(packed[:k, None, CLASSES + 1:].numpy()),
            normalized_cls_grad(g["gradients"][LAYER]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(packed[:k, CLASSES].numpy(), g["pred"])
    finally:
        _stop(server, handler)


def test_decode_seam_gives_the_files_answers(world):
    frames, opened = {}, []
    for v in world["videos"]:
        r = tvd.open_video(v)
        frames[v] = r.get_batch(np.arange(len(r)))
        r.release()

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

    file_server, file_handler = _serve(world)
    seam_server, seam_handler = _serve(world, decode=Reader)
    try:
        for v in world["videos"]:
            want = _post(file_server.server_address[1], {"video": v})
            assert _post(seam_server.server_address[1], {"video": v}) == want
        assert opened == list(world["videos"])
    finally:
        _stop(file_server, file_handler)
        _stop(seam_server, seam_handler)


# -- cli.serve and the demo pages ------------------------------------------------------------

def test_serve_cli_registers_explain_and_serves_the_demo(world, monkeypatch):
    built = {}

    def fake_create_server(service, host, port, demo_dir=None):
        built.update(service=service, demo_dir=demo_dir)
        raise KeyboardInterrupt            # stop before serving

    monkeypatch.setattr(tserve, "create_server", fake_create_server)
    argv = ["--explain_checkpoint", world["ckpt"], "--device", "cpu",
            "--target_layer", str(LAYER), "--concept_banks", world["banks"],
            "--label_names", world["names"], "--port", "0"]
    for demo in (False, True):
        with pytest.raises(KeyboardInterrupt):
            tserve.main(argv + (["--demo"] if demo else []))
        assert sorted(built["service"].handlers) == ["explain"]
        handler = built["service"].handlers["explain"]
        assert handler.target_layer == LAYER
        handler.batcher.close()
        assert built["demo_dir"] == (DEMO_DIR if demo else None)


@pytest.mark.parametrize("name", DEMO_FILES)
def test_demo_file_is_the_jax_file(name):
    assert len(DEMO_FILES) == 7
    with open(os.path.join(DEMO_DIR, name), "rb") as f, \
            open(os.path.join(JAX_DEMO_DIR, name), "rb") as g:
        assert f.read() == g.read()


def test_demo_pages_served_beside_the_explain_route(world):
    """GET /demo/<page> serves the copies; the explain page's route
    answers; a page whose route is not registered gets a 404."""
    server, handler = _serve(world, demo_dir=DEMO_DIR)
    try:
        port = server.server_address[1]
        for name in DEMO_FILES:
            with bserve._LOCAL.open(f"http://127.0.0.1:{port}/demo/{name}",
                                    timeout=30) as r:
                with open(os.path.join(DEMO_DIR, name), "rb") as f:
                    assert r.status == 200 and r.read() == f.read()
        assert _post(port, {"video": world["videos"][0]})["prediction"] \
            .startswith("label")
        for route in ("caption", "retrieval", "composed_retrieval"):
            with pytest.raises(urllib.error.HTTPError) as e:
                bserve.request(port, route, {"video": "x.mp4"})
            assert e.value.code == 404
    finally:
        _stop(server, handler)


def test_explain_route_needs_no_banks_or_names(world):
    """Without banks the answer has no `<level>_top`; without label names
    the prediction is the class index, as in JAX."""
    args = argparse.Namespace(explain_checkpoint=world["ckpt"],
                              target_layer=LAYER)
    jh = jserve.build_explain_handler(argparse.Namespace(
        **vars(args), concept_banks=None, label_names=None))
    server, handler = _serve(world, concept_banks=None, label_names=None)
    try:
        got = _post(server.server_address[1], {"video": world["videos"][2]})
        assert sorted(got) == ["prediction", "scores"]
        assert isinstance(got["prediction"], int)
        _same_answer(got, jh({"video": world["videos"][2]}))
    finally:
        _stop(server, handler)
        jh.batcher.close()


# -- the bench arm and its fixtures ----------------------------------------------------------

def test_explain_serving_bench_runs_on_the_cpu(tmp_path, capsys,
                                              monkeypatch):
    """The bench's route runs the shipped test pipeline (224² crops), so
    the model is 224² at patch 56 (16 patches a frame)."""
    monkeypatch.setattr(tci, "DEFAULT_PIPELINE", SHIPPED_PIPELINE)
    backbone = dict(BACKBONE, img_size=224, patch_size=56)
    rows = bserve.run_explain(device="cpu", root=str(tmp_path),
                              backbone=backbone, num_classes=CLASSES,
                              n_single=3, burst=3, wave_calls=2, n_videos=2,
                              video_shape=(40, 36, 48))
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    metrics = [r["metric"] for r in rows]
    assert metrics == ["serve_explain_batch1", "serve_explain_burst3",
                       "serve_explain_wave1", "serve_explain_wave8",
                       "serve_explain_pipeline"]
    assert [r["metric"] for r in printed] == metrics
    for r in rows:
        assert r["device"] == "cpu" and np.isfinite(r["value"])
        assert r["unit"] in ("ms/cpu", "ms/host")
        assert r["target_layer"] == BACKBONE["num_layers"] - 2
    for r in rows[2:4]:
        assert r["capture_ms"] > 0 and r["grad_ms"] > 0
        assert r["phase_clock"] == "host" and r["peak_mb"] is None
        # the plain version runs on the CPU: no kernel launch is counted
        assert r["flash_launches"] == 0 and r["events_ms"] is None
    assert rows[0]["n"] == 3 and rows[1]["n"] == 3
    assert rows[3]["wave_rows"] == 8
    assert list(tmp_path.iterdir()) == []          # fixtures removed


def test_explain_checkpoint_and_banks_fixtures(tmp_path):
    """The bench's checkpoint is the seeded state dict in the JAX format
    (both packages load it); its banks are what load_concept_banks reads
    in both packages."""
    path = str(tmp_path / "c")
    sd = bserve.write_explain_checkpoint(path, BACKBONE, CLASSES, seed=3)
    want = random_state_dict(TimeSformerConfig(**BACKBONE), 3,
                             num_classes=CLASSES)
    model, cfg_d = tdemo.load_explain_model(path, device="cpu")
    assert cfg_d == {"backbone": BACKBONE, "num_classes": CLASSES}
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]) and torch.equal(t, want[k]), k
    _, jcfg, _ = jax_load_checkpoint(path)
    assert jcfg["num_classes"] == CLASSES
    banks = bserve.write_concept_banks(str(tmp_path / "b.npz"), 16,
                                       objects=4, clusters=3, seed=1)
    for loader in (tdemo.load_concept_banks, jdemo.load_concept_banks):
        loaded = loader(str(tmp_path / "b.npz"))
        for level, (matrix, names) in banks.items():
            assert loaded[level].names == names
            np.testing.assert_array_equal(loaded[level].matrix, matrix)
    assert banks["symbolic"][0].shape == (4, 16)
    assert banks["cluster"][0].shape == (12, 16)
