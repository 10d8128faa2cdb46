"""The port's host tools against the JAX package's: DecodePrefetcher and
uniform_indices (io/pipeline.py), PrefetchIterator (data/prefetch.py),
the ranking scorers (metrics/scorers.py), the training meters
(utils/logging.py), the concept tags (utils/concept_tags.py) and every
ported subcommand of cli/data_tools.py and cli/misc_tools.py, on the same
inputs.  Batches are compared bit for bit and the tools' files byte for
byte; the scorers exactly.

The decode cases need g++ and libav (the port builds native/*.cc on first
use) and skip naming what is missing where one is not there.  The card
half of PrefetchIterator (pinned memory, the side stream) is in
tests/test_torch_prefetch_cuda.py.
"""

import io
import json
import os
import shutil
import sys
import threading
import time
import wave

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import data_tools as jdt
from cross_modal_video_engine_tpu.cli import misc_tools as jmt
from cross_modal_video_engine_tpu.data import prefetch as jprefetch
from cross_modal_video_engine_tpu.io import pipeline as jpipe
from cross_modal_video_engine_tpu.io.bigfile import write_bigfile
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.metrics import scorers as jscorers
from cross_modal_video_engine_tpu.utils import concept_tags as jtags
from cross_modal_video_engine_tpu.utils import logging as jlog
from cross_modal_video_engine_tpu_torch import metrics as tmetrics
from cross_modal_video_engine_tpu_torch.cli import data_tools as tdt
from cross_modal_video_engine_tpu_torch.cli import misc_tools as tmt
from cross_modal_video_engine_tpu_torch.data import prefetch as tprefetch
from cross_modal_video_engine_tpu_torch.io import _native_build
from cross_modal_video_engine_tpu_torch.io import pipeline as tpipe
from cross_modal_video_engine_tpu_torch.metrics import scorers as tscorers
from cross_modal_video_engine_tpu_torch.utils import concept_tags as ttags
from cross_modal_video_engine_tpu_torch.utils import logging as tlog

TIMEOUT = 60.0      # seconds a prefetcher case may take before it hangs


def _libav_missing():
    if shutil.which("g++") is None and not os.environ.get("CXX"):
        return "needs g++ to build native/decode.cc"
    probe = _native_build.libav_probe()
    return None if probe.found else probe.reason


needs_libav = pytest.mark.skipif(_libav_missing() is not None,
                                 reason=str(_libav_missing()))


def within(seconds: float, fn):
    """fn() in a thread; fails if it has not returned after `seconds` (a
    hang), else returns its result or raises its error."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:       # handed to the test's thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s (a hang)"
    if "err" in box:
        raise box["err"]
    return box["out"]


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# -- DecodePrefetcher ------------------------------------------------------------

@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("vids")
    rng = np.random.default_rng(31)
    paths = []
    for i in range(7):
        frames = rng.integers(0, 256, (10, 32, 48, 3), dtype=np.uint8)
        paths.append(str(d / f"v{i}.mp4"))
        write_test_video(paths[-1], frames)
    return paths


def test_uniform_indices_match_jax():
    for n, total, clip in ((3, 10, 4), (2, 1, 3), (5, 300, 8), (1, 0, 2)):
        got = tpipe.uniform_indices(n, total, clip)
        np.testing.assert_array_equal(got, jpipe.uniform_indices(n, total,
                                                                 clip))
        assert got.dtype == np.int64


@needs_libav
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_prefetcher_batches_match_jax(videos, workers):
    """The same batches (frames and paths) in the same order, the tail
    smaller, with 1, 2 and 4 workers."""
    idx = tpipe.uniform_indices(len(videos), 10, 4)
    idx[::2] = idx[::2][:, ::-1]                   # some reversed clips

    def run(mod):
        pf = mod.DecodePrefetcher(videos, idx, out_hw=(16, 24), batch_size=3,
                                  n_workers=workers, depth=2,
                                  decode_threads=2)
        return len(pf), list(pf)

    n, got = within(TIMEOUT, lambda: run(tpipe))
    jn, want = run(jpipe)
    assert n == jn == 3
    assert [b.shape for b, _ in got] == [(3, 4, 16, 24, 3)] * 2 + [
        (1, 4, 16, 24, 3)]
    for (b, p), (jb, jp) in zip(got, want, strict=True):
        np.testing.assert_array_equal(b, jb)
        assert p == jp
    assert [p for _, ps in got for p in ps] == videos
    assert list(tpipe.DecodePrefetcher([], np.zeros((0, 2)), (16, 16),
                                       4)) == []


@needs_libav
def test_prefetcher_zero_fills_a_missing_video(videos, tmp_path):
    idx = tpipe.uniform_indices(2, 10, 2)
    paths = [videos[0], str(tmp_path / "missing.mp4")]
    (got, _), = within(TIMEOUT, lambda: list(tpipe.DecodePrefetcher(
        paths, idx, out_hw=(16, 16), batch_size=2)))
    (want, _), = list(jpipe.DecodePrefetcher(paths, idx, out_hw=(16, 16),
                                             batch_size=2))
    np.testing.assert_array_equal(got, want)
    assert got[1].max() == 0 and got[0].max() > 0


@pytest.mark.parametrize("workers", [1, 2])
def test_worker_error_raised_at_consume_time(monkeypatch, workers):
    """A worker's exception reaches the consumer at its batch, after the
    batches before it, in both packages."""
    def fake(bpaths, bidx, out_w, out_h, n_threads=4):
        if "bad" in bpaths:
            raise ValueError("cannot decode bad")
        return np.zeros((len(bpaths), 2, out_h, out_w, 3), np.uint8)

    paths = ["a", "b", "bad", "c", "d"]
    idx = np.zeros((5, 2), np.int64)
    for mod in (tpipe, jpipe):
        monkeypatch.setattr(mod, "decode_videos_batch", fake)
        seen = []

        def consume():
            for _, ps in mod.DecodePrefetcher(paths, idx, (4, 4), 2,
                                              n_workers=workers, depth=1):
                seen.append(ps)

        with pytest.raises(ValueError, match="cannot decode bad"):
            within(TIMEOUT, consume)
        assert seen == [["a", "b"]]


def test_early_break_reaps_workers(monkeypatch):
    """Leaving the loop after the first batch stops and joins every
    worker, also those parked on their lookahead bound."""
    def fake(bpaths, bidx, out_w, out_h, n_threads=4):
        time.sleep(0.01)
        return np.zeros((len(bpaths), 2, out_h, out_w, 3), np.uint8)

    monkeypatch.setattr(tpipe, "decode_videos_batch", fake)
    before = threading.active_count()

    def run():
        pf = tpipe.DecodePrefetcher([f"v{i}" for i in range(40)],
                                    np.zeros((40, 2), np.int64), (4, 4), 2,
                                    n_workers=4, depth=1)
        for _ in pf:
            break

    within(TIMEOUT, run)
    assert threading.active_count() <= before


def test_lookahead_bound_is_per_worker(monkeypatch):
    """While batch 0 stalls, worker 1 starts at most `depth` batches and
    the consumer still gets every batch in order once the stall clears
    (the deadlock a shared token pool had)."""
    n_batches, depth = 10, 2
    started, lock = set(), threading.Lock()
    release = threading.Event()

    def fake(bpaths, bidx, out_w, out_h, n_threads=4):
        bi = int(bpaths[0].split("_")[-1])
        with lock:
            started.add(bi)
        if bi == 0:
            release.wait(timeout=10.0)
        return np.zeros((len(bpaths), 2, out_h, out_w, 3), np.uint8)

    monkeypatch.setattr(tpipe, "decode_videos_batch", fake)
    paths = [f"b_{i}" for i in range(n_batches)]
    pf = tpipe.DecodePrefetcher(paths, np.zeros((n_batches, 2), np.int64),
                                out_hw=(4, 4), batch_size=1, n_workers=2,
                                depth=depth)
    got = []
    consumer = threading.Thread(
        target=lambda: got.extend(p for _, ps in pf for p in ps),
        daemon=True)
    consumer.start()
    prev, stable, deadline = None, 0, time.monotonic() + 20.0
    while stable < 3 and time.monotonic() < deadline:
        time.sleep(0.2)
        with lock:
            cur = sorted(started)
        stable = stable + 1 if cur == prev and len(cur) >= 2 else 0
        prev = cur
    assert prev == [0] + list(range(1, 1 + 2 * depth, 2)), prev
    release.set()
    consumer.join(timeout=TIMEOUT)
    assert not consumer.is_alive(), "prefetcher deadlocked"
    assert got == paths


# -- PrefetchIterator ------------------------------------------------------------

def _batches(n=5):
    rng = np.random.default_rng(41)
    for i in range(n):
        yield {"clips": rng.standard_normal((2, 3, 4)).astype(np.float32),
               "labels": (rng.integers(0, 9, 2).astype(np.int32),
                          np.uint8(i)),
               "rows": [rng.integers(0, 255, (3,), dtype=np.uint8)],
               "none": None}


def _leaves(batch):
    return jprefetch.jax.tree.leaves(batch)


def test_prefetch_without_placement_yields_the_batches():
    got = within(TIMEOUT, lambda: list(tprefetch.prefetch(
        _batches(), depth=2, device_put=False)))
    want = list(jprefetch.prefetch(_batches(), depth=2, device_put=False))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert jprefetch.jax.tree.structure(g) == \
            jprefetch.jax.tree.structure(w)
        for a, b in zip(_leaves(g), _leaves(w)):
            assert type(a) is type(b)
            np.testing.assert_array_equal(a, b)


def test_prefetch_places_leaves_on_the_cpu():
    """device_put on the CPU: every leaf a tensor on the device, equal to
    the JAX package's placed leaf, the structure kept (None too)."""
    got = within(TIMEOUT, lambda: list(tprefetch.PrefetchIterator(
        _batches(), depth=1, device="cpu")))
    want = list(jprefetch.PrefetchIterator(_batches(), depth=1))
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w) and g["none"] is None
        assert isinstance(g["labels"], tuple) and isinstance(g["rows"], list)
        for a, b in zip(_leaves(g), _leaves(w), strict=True):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prefetch_surfaces_errors_and_refuses_sharding():
    def bad():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("worker boom")

    for mod, kw in ((tprefetch, {"device": "cpu"}), (jprefetch, {})):
        it = mod.prefetch(bad(), device_put=True, **kw)
        next(it)
        with pytest.raises(RuntimeError, match="worker boom"):
            within(TIMEOUT, lambda: next(it))
    with pytest.raises(NotImplementedError, match="item 11"):
        tprefetch.PrefetchIterator(_batches(), sharding=object())


def test_prefetch_runs_ahead():
    """`depth` batches are produced while the consumer holds one."""
    made = []

    def source():
        for i in range(6):
            made.append(i)
            yield np.full(2, i, np.float32)

    it = tprefetch.prefetch(source(), depth=2, device="cpu")
    first = next(it)
    deadline = time.monotonic() + 10.0
    while len(made) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert first.tolist() == [0.0, 0.0] and len(made) == 4
    assert [int(x[0]) for x in it] == [1, 2, 3, 4, 5]


# -- scorers, meters, concept tags ----------------------------------------------

def test_metrics_exports_the_scorers():
    assert tmetrics.getScorer is tscorers.getScorer
    for name in ("APScorer", "RRScorer", "PrecisionScorer", "DCGScorer",
                 "NDCGScorer"):
        assert getattr(tmetrics, name) is getattr(tscorers, name)


@pytest.mark.parametrize("name", ["P@5", "AP", "AP@3", "RR", "NDCG@10",
                                  "DCG@4", "P@0"])
def test_scorers_match_jax(name):
    rng = np.random.default_rng(51)
    port, ref = tscorers.getScorer(name), jscorers.getScorer(name)
    assert port.name() == ref.name()
    for length in (1, 4, 12):
        for _ in range(5):
            labels = rng.integers(-1, 3, length).tolist()
            assert port.score(labels) == ref.score(labels)
            assert port.getLength(labels) == ref.getLength(labels)
    assert port.score([0] * 6) == ref.score([0] * 6)


def test_meters_and_progress_bar_match_jax():
    logs = {"port": [], "jax": []}
    for name, mod in (("port", tlog), ("jax", jlog)):
        meter = mod.AverageMeter()
        for v, n in ((1.5, 2), (0.25, 1), (3.0, 4)):
            meter.update(v, n)
        col = mod.LogCollector(sink=lambda k, v, s, log=logs[name]:
                               log.append((k, v, s)))
        for k, v in (("loss", 0.5), ("rsum", 1.25), ("loss", 0.75)):
            col.update(k, v)
        col.tb_log(7, prefix="train/")
        stream = io.StringIO()
        bar = mod.Progbar(3, width=10, stream=stream)
        bar.add(1, {"loss": 0.5})
        bar.add(5)
        text = stream.getvalue()
        logs[name] += [str(meter), meter.avg, meter.count, str(col),
                       text[:text.rindex("(")]]
        assert text.endswith("s)\n")
    assert logs["port"] == logs["jax"]
    assert mod.AverageMeter().avg == tlog.AverageMeter().avg == 0.0


CAPTIONS = ["A man is riding a horse on the beach.",
            "Two dogs are running in the snow",
            "a man rides horses while people watching",
            "the dogs were playing with balls in a field",
            "Cooking: a woman is cutting vegetables",
            "a chef cuts the onions and carrots"]


def test_concept_tags_match_jax(tmp_path):
    assert (ttags._wnl() is None) == (jtags._wnl() is None)
    for size in (5, 512):
        assert ttags.build_tag_vocab(CAPTIONS, size) == \
            jtags.build_tag_vocab(CAPTIONS, size)
    vocab = ttags.build_tag_vocab(CAPTIONS, 12)
    per_video = {"v1": CAPTIONS[:3], "v2": CAPTIONS[3:4], "v3": CAPTIONS[4:],
                 "v4": ["!!"]}
    scores = ttags.video_tag_scores(per_video, vocab)
    assert scores == jtags.video_tag_scores(per_video, vocab)
    assert scores["v4"] == []
    ttags.write_tag_file(str(tmp_path / "t.txt"), scores)
    jtags.write_tag_file(str(tmp_path / "j.txt"), scores)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    assert "v4" not in (tmp_path / "t.txt").read_text()


# -- cli/data_tools --------------------------------------------------------------

def _both(tmp_path, capsys, argv_of, tool="data"):
    """Run the JAX and the port subcommand, each writing under its own
    directory: (port's tree, JAX's tree, port's stdout, JAX's stdout,
    return codes)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    outs = {}
    for name, main in (("port", (tdt if tool == "data" else tmt).main),
                       ("jax", (jdt if tool == "data" else jmt).main)):
        out = tmp_path / f"out_{name}"
        out.mkdir()
        rc = main(argv_of(out))
        outs[name] = (tree_bytes(out), capsys.readouterr().out.replace(
            str(out), "OUT"), rc)
    return outs["port"], outs["jax"]


def test_txt2bin_and_combine_features(tmp_path, capsys):
    rng = np.random.default_rng(61)
    txt = tmp_path / "feats.txt"
    txt.write_text("".join(
        f"v{i} " + " ".join(f"{x:.6f}" for x in rng.standard_normal(5))
        + "\n" + ("\n" if i == 2 else "") for i in range(6)))
    port, ref = _both(tmp_path, capsys, lambda out: [
        "txt2bin", "--input", str(txt), "--output", str(out / "bf")])
    assert port == ref and port[0]["bf/feature.bin"]
    write_bigfile(str(tmp_path / "b"), ["v4", "v1", "x"],
                  rng.standard_normal((3, 3)).astype(np.float32))
    port, ref = _both(tmp_path / "b", capsys, lambda out: [
        "combine_features", "--a", str(tmp_path / "out_port" / "bf"),
        "--b", str(tmp_path / "b"), "--output", str(out / "c")])
    assert port == ref
    assert port[0]["c/id.txt"].split() == [b"v1", b"v4"]


def _captions(tmp_path):
    lines = ["v1#0 A man is riding a horse", "v1#1 the horse runs",
             "v2#0 dogs play in snow", "v2#1 dogs play in snow",
             "v3#0 a woman cuts vegetables", "v3#1 cooking in a kitchen",
             "v3#2 the woman is cooking"] * 3
    path = tmp_path / "caps.txt"
    path.write_text("\n".join(f"{c.split(' ', 1)[0]}{'' if i < 7 else i} "
                              f"{c.split(' ', 1)[1]}"
                              for i, c in enumerate(lines)) + "\n")
    return path


@pytest.mark.parametrize("case", ["clean", "faults"])
def test_format_check(tmp_path, capsys, case):
    rng = np.random.default_rng(62)
    caps = tmp_path / "caps.txt"
    rows = ["v1#0 a man", "v2#0 a dog"]
    if case == "faults":
        rows += ["v3 no hash", "v1#0 duplicate", "v4#0 unseen video"]
    caps.write_text("\n".join(rows) + "\n")
    write_bigfile(str(tmp_path / "bf"), ["f1", "f2"],
                  rng.standard_normal((2, 2)).astype(np.float32))
    (tmp_path / "v2f.txt").write_text(
        "{'v1': ['f1'], 'v2': ['f2', 'f9']}" if case == "faults"
        else "{'v1': ['f1'], 'v2': ['f2']}")
    port, ref = _both(tmp_path, capsys, lambda out: [
        "format_check", "--captions", str(caps), "--features",
        str(tmp_path / "bf"), "--video2frames", str(tmp_path / "v2f.txt")])
    assert port == ref
    assert port[2] == (1 if case == "faults" else 0)


def test_build_vocab_and_tags(tmp_path, capsys):
    caps = _captions(tmp_path)
    port, ref = _both(tmp_path, capsys, lambda out: [
        "build_vocab", "--captions", str(caps), "--output", str(out),
        "--threshold", "2"])
    assert port == ref and "rnn/word_vocab_2.json" in port[0]
    port, ref = _both(tmp_path / "out_port", capsys, lambda out: [
        "build_tags", "--captions", str(caps), "--output",
        str(out / "tags" / "tags.txt"), "--vocab_size", "6"])
    assert port == ref
    assert json.loads(port[0]["tags/tags.txt.vocab.json"])


def _class_tree(root, videos):
    for cls, names in videos.items():
        (root / cls).mkdir(parents=True)
        for v in names:
            (root / cls / v).write_bytes(f"{cls}/{v}".encode())


def test_gen_videolist_and_organize_masks(tmp_path, capsys):
    train = tmp_path / "train"
    _class_tree(train, {"jump": ["a.mp4", "b.mp4"], "run": ["c.mp4"]})
    mask = tmp_path / "flat"
    _class_tree(mask, {"person": ["a.mp4", "c.mp4", "z.mp4"],
                       "ball": ["b.mp4"]})
    (mask / "stray.txt").write_text("x")
    port, ref = _both(tmp_path, capsys, lambda out: [
        "organize_masks", "--train_root", str(train), "--mask_root",
        str(mask), "--target_root", str(out / "tree")])
    assert port == ref and len(port[0]) == 3
    port, ref = _both(tmp_path / "out_port", capsys, lambda out: [
        "gen_videolist", "--train_root", str(train), "--mask_root",
        str(tmp_path / "out_port" / "tree"), "--output", str(out)])
    assert port == ref
    assert set(port[0]) == {"trainlist_classwise/jump.txt",
                            "trainlist_classwise/run.txt",
                            "conceptlist_classwise/jump.txt",
                            "conceptlist_classwise/run.txt"}


@needs_libav
def test_build_rawframes_and_file_list(tmp_path, capsys):
    rng = np.random.default_rng(63)
    src = tmp_path / "videos"
    for cls in ("jump", "run"):
        (src / cls).mkdir(parents=True)
        write_test_video(str(src / cls / f"{cls}1.avi"),
                         rng.integers(0, 256, (6, 48, 64, 3),
                                      dtype=np.uint8))
    (src / "run" / "notes.txt").write_text("skip me")
    for short in ("0", "32"):
        port, ref = _both(tmp_path / f"s{short}", capsys, lambda out: [
            "build_rawframes", "--src_dir", str(src), "--out_dir", str(out),
            "--ext", "avi", "--new_short", short])
        assert port == ref
        assert sorted(port[0])[0] == os.path.join("jump", "jump1",
                                                  "img_00001.jpg")
        assert len(port[0]) == 12
    frames = tmp_path / "s32" / "out_port"
    for fmt, root in (("rawframes", frames), ("videos", src)):
        port, ref = _both(tmp_path / f"list_{fmt}", capsys, lambda out: [
            "build_file_list", "--src_dir", str(root), "--output",
            str(out / "lists" / "ann.txt"), "--format", fmt])
        assert port == ref
    assert port[0]["lists/ann.txt"].splitlines()[0] == b"jump/jump1.avi 0"


def write_wav(path, y, sr, channels=1):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        data = y if channels == 1 else np.stack([y] * channels, 1).ravel()
        f.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


@needs_libav
def test_extract_audio(tmp_path, capsys):
    """Mono and stereo 16 kHz WAVs to mono 16 kHz WAVs, the same bytes as
    the JAX tool's (no resampling), a video without audio skipped; a
    stereo 44.1 kHz WAV resampled onto its sine within 1e-3 (the JAX
    tool's decoder cuts it at every frame: test_torch_native.py)."""
    src = tmp_path / "media"
    (src / "sub").mkdir(parents=True)
    t = np.arange(16000) / 16000
    write_wav(src / "a.wav", 0.3 * np.sin(2 * np.pi * 500 * t), 16000, 2)
    write_wav(src / "sub" / "b.wav", 0.2 * np.sin(2 * np.pi * 200 * t),
              16000)
    write_test_video(str(src / "v.avi"),
                     np.zeros((4, 16, 16, 3), np.uint8))
    port, ref = _both(tmp_path, capsys, lambda out: [
        "extract_audio", "--src_dir", str(src), "--out_dir", str(out),
        "--ext", "wav,avi"])
    assert port == ref
    assert set(port[0]) == {"a.wav", os.path.join("sub", "b.wav")}
    assert "(1 without audio)" in port[1]
    hi = tmp_path / "hi"
    hi.mkdir()
    t = np.arange(44100) / 44100
    write_wav(hi / "c.wav", 0.3 * np.sin(2 * np.pi * 500 * t), 44100, 2)
    tdt.main(["extract_audio", "--src_dir", str(hi), "--out_dir",
              str(tmp_path / "hi_out"), "--ext", "wav"])
    with wave.open(str(tmp_path / "hi_out" / "c.wav")) as f:
        assert (f.getnchannels(), f.getframerate()) == (1, 16000)
        y = np.frombuffer(f.readframes(f.getnframes()), "<i2") / 32767
    want = 0.3 * np.sin(2 * np.pi * 500 * np.arange(len(y)) / 16000)
    assert abs(len(y) - 16000) <= 32
    assert np.abs(y - want)[32:-32].max() < 1e-3
    capsys.readouterr()


def test_build_audio_features_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8g"):
        tdt.main(["build_audio_features", "--src_dir", str(tmp_path),
                  "--out_dir", str(tmp_path / "o")])


# -- cli/misc_tools --------------------------------------------------------------

@needs_libav
def test_flow_extraction(tmp_path, capsys):
    frames = np.zeros((6, 48, 48, 3), np.uint8)
    for t in range(6):
        frames[t, 10:20, 5 + 4 * t:15 + 4 * t] = (255, 120, 30)
    vid = str(tmp_path / "v.avi")
    write_test_video(vid, frames)
    port, ref = _both(tmp_path, capsys, lambda out: [
        "flow_extraction", "--input", vid, "--dest", str(out / "flow"),
        "--save_rgb", "--bound", "15"], tool="misc")
    assert port == ref
    assert len(port[0]) == 15 and "flow/flow_x_00004.jpg" in port[0]


def test_publish_model(tmp_path, capsys):
    names = {}
    for name, main in (("port", tmt.main), ("jax", jmt.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "model.npz").write_bytes(b"weights of the model")
        out = main(["publish_model", "--input", str(d / "model.npz")])
        assert capsys.readouterr().out.strip() == out
        assert not (d / "model.npz").exists()
        names[name] = (os.path.basename(out), open(out, "rb").read())
    assert names["port"] == names["jax"]
    assert names["port"][0].startswith("model-")


def test_cv2_tools_name_cv2_without_it(tmp_path):
    """build_rawframes and flow_extraction on a machine without cv2: an
    ImportError naming cv2, before anything is decoded or written."""
    import subprocess
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "from cross_modal_video_engine_tpu_torch.cli import data_tools, "
        "misc_tools\n"
        "for main, argv in ((data_tools.main, ['build_rawframes', "
        "'--src_dir', sys.argv[1], '--out_dir', sys.argv[1] + '/o']),\n"
        "                   (misc_tools.main, ['flow_extraction', "
        "'--input', 'v.avi', '--dest', sys.argv[1] + '/f'])):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except ImportError as e:\n"
        "        print('cv2' in str(e))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.split() == ["True", "True"], out.stderr
    assert os.listdir(tmp_path) == []


# -- bench/extra.py's host-feed row ----------------------------------------------

SMALL_CLIP = dict(embed_dim=16, image_resolution=32, vision_width=64,
                  vision_layers=2, vision_heads=4, patch_size=8,
                  context_length=8, vocab_size=64, text_width=32,
                  text_heads=2, text_layers=2)


@needs_libav
def test_host_feed_row_on_the_cpu(capsys):
    """The row tiny on the CPU: one decode row per worker count and the
    end-to-end row, each naming its fixture and the CPU."""
    from cross_modal_video_engine_tpu_torch.bench import common, extra
    with torch.random.fork_rng(devices=[]):
        rows = extra.bench_host_feed(
            n_videos=5, frames=2, batch=2, src_hw=(48, 64), src_frames=6,
            n_src=2, workers_sweep=(1, 2), device="cpu",
            cfg=common.flagship_config(**SMALL_CLIP))
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["metric"] for r in rows] == [
        "host_decode_480p_to_224_w1", "host_decode_480p_to_224_w2",
        "host_feed_e2e_decode_embed_vitb32_bf16"]
    for r in rows:
        assert r["fixture"] == "rawvideo-avi" and r["device"] == "cpu"
        assert r["value"] > 0 and r["vs_baseline"] is None
        assert not r["unit"].endswith("/chip")


@needs_libav
def test_host_feed_e2e_embeds_the_decoded_clips(tmp_path):
    """host_feed_e2e's last batch (the padded tail) equals the tower on
    the same clips decoded directly."""
    from cross_modal_video_engine_tpu_torch.bench import common, extra
    from cross_modal_video_engine_tpu_torch.io.native import (
        decode_videos_batch)
    from cross_modal_video_engine_tpu_torch.models.clip import (
        CLIPModel, seeded_state_dict)
    cfg = common.flagship_config(**SMALL_CLIP)
    srcs = extra.write_host_feed_fixture(str(tmp_path), 2, 6, (40, 48),
                                         seed=3)
    paths = [srcs[i % 2] for i in range(5)]
    idx = tpipe.uniform_indices(5, 6, 2)
    with torch.random.fork_rng(devices=[]):
        model = CLIPModel(cfg, device="cpu")
    model.load_state_dict(seeded_state_dict(cfg, 0))
    out = extra.host_feed_e2e(model.eval(), paths, idx, batch=2)
    assert out["batches"] == 3 and out["embeddings"].shape == (1, 2, 16)
    frames = decode_videos_batch(paths[4:], idx[4:], 32, 32)
    with torch.no_grad():
        want = model.encode_video_u8(torch.from_numpy(frames))[0]
    np.testing.assert_allclose(out["embeddings"], want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_fixture_kind_reads_the_extension():
    from cross_modal_video_engine_tpu_torch.bench import extra
    assert extra.fixture_kind(["a/s0.avi", "s1.AVI"]) == "rawvideo-avi"
    assert extra.fixture_kind(["s0.mp4"]) == "mp4v"
    for paths in (["s0.avi", "s1.mp4"], ["s0.mkv"], []):
        with pytest.raises(ValueError, match="all .avi or all .mp4"):
            extra.fixture_kind(paths)


@needs_libav
def test_host_feed_row_refuses_a_decode_of_zeros(tmp_path):
    """A clip the decoder fails on comes back as zeros: the decode-only
    and the end-to-end loops raise instead of timing it."""
    from cross_modal_video_engine_tpu_torch.bench import common, extra
    from cross_modal_video_engine_tpu_torch.models.clip import CLIPModel
    srcs = extra.write_host_feed_fixture(str(tmp_path), 2, 6, (40, 48))
    paths = srcs + [str(tmp_path / "missing.avi")]
    idx = tpipe.uniform_indices(3, 6, 2)
    with pytest.raises(RuntimeError, match="1 of 3 clips decoded as zeros"):
        extra.host_decode_rate(paths, idx, 2, 1, (32, 32))
    with torch.random.fork_rng(devices=[]):
        model = CLIPModel(common.flagship_config(**SMALL_CLIP),
                          device="cpu").eval()
    with pytest.raises(RuntimeError, match="1 of 3 clips decoded as zeros"):
        extra.host_feed_e2e(model, paths, idx, batch=2)


# the row with libav forced missing (the probe links a library that is
# not there), as on a machine without libav's headers
NO_LIBAV_ROW = (
    "import sys, json\n"
    "from pathlib import Path\n"
    "from cross_modal_video_engine_tpu_torch.io import _native_build as b\n"
    "b.BUILD_ROOT = Path(sys.argv[1]) / 'build'\n"
    "b.LIBAV = b.LIBAV + ('-lcmve_no_such_library',)\n"
    "from cross_modal_video_engine_tpu_torch.bench import common, extra\n"
    "case = sys.argv[2]\n"
    "srcs = None\n"
    "if case == 'raw_avi':\n"
    "    srcs = extra.write_host_feed_fixture(sys.argv[1], 2, 6, (48, 64))\n"
    "if case == 'no_cv2':\n"
    "    sys.modules['cv2'] = None\n"
    "cfg = common.flagship_config(**json.loads(sys.argv[3]))\n"
    "try:\n"
    "    rows = extra.bench_host_feed(\n"
    "        n_videos=5, frames=2, batch=2, src_hw=(48, 64), src_frames=6,\n"
    "        n_src=2, workers_sweep=(1,), device='cpu', cfg=cfg, srcs=srcs)\n"
    "except SystemExit as e:\n"
    "    print(json.dumps({'exit': str(e)}))\n")


@pytest.mark.skipif(shutil.which("g++") is None and not os.environ.get("CXX"),
                    reason="needs g++ to build native/bigfile.cc")
@pytest.mark.parametrize("case", ["mp4", "raw_avi", "no_cv2"])
def test_host_feed_row_without_libav(tmp_path, case):
    """Where libav was not found the row writes its sources as mp4s and
    times cv2's fallback on them; it refuses, naming the probe's verdict,
    to hand raw AVIs to cv2 (which crashes on them) or to run with no
    decoder at all."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", NO_LIBAV_ROW, str(tmp_path), case,
         json.dumps(SMALL_CLIP)], cwd=root, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = [json.loads(l) for l in proc.stdout.splitlines()]
    if case == "mp4":
        assert [r["metric"] for r in out] == [
            "host_decode_480p_to_224_w1",
            "host_feed_e2e_decode_embed_vitb32_bf16"]
        for r in out:
            assert r["fixture"] == "mp4v"
            assert r["decoder"] == "cv2 (fallback)" and r["value"] > 0
        return
    assert len(out) == 1 and "cmve_no_such_library" in out[0]["exit"]
    assert out[0]["exit"].endswith(
        "cannot read the raw-AVI fixture" if case == "raw_avi"
        else "cv2 is not installed: no decoder")
