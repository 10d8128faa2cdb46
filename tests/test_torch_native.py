"""The port's native host IO layer (io/native.py, io/_native_build.py)
against the JAX package's (cross_modal_video_engine_tpu/io/native.py,
its committed libraries built from native/*.cc).

The port compiles its own copy of the C++ sources with g++ on first use;
these tests need g++ (every case) and libav's headers and libraries (the
decode cases), and skip naming what is missing where one is not there.
Decoded frames are compared bit for bit with the JAX package's decoder
on the same files; the audio bit for bit with the JAX package's where
it is not resampled, and within 1e-3 of the analytic sine where it is
(the port's copy of decode.cc repairs the JAX decoder's resampler
drain, which cuts resampled audio at every decoded frame).
"""

import os
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from cross_modal_video_engine_tpu.io import native as jnative
from cross_modal_video_engine_tpu.io.bigfile import write_bigfile
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu_torch.bench.extra import write_raw_avi
from cross_modal_video_engine_tpu_torch.io import _native_build as build
from cross_modal_video_engine_tpu_torch.io import native

ROOT = Path(__file__).resolve().parents[1]
needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None and not os.environ.get("CXX"),
    reason="needs g++ to build native/*.cc")


def _libav_missing():
    if shutil.which("g++") is None and not os.environ.get("CXX"):
        return "needs g++ to build native/decode.cc"
    probe = build.libav_probe()
    return None if probe.found else probe.reason


needs_libav = pytest.mark.skipif(_libav_missing() is not None,
                                 reason=str(_libav_missing()))


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def write_wav(path, y, sr, channels=1):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(sr)
        data = y if channels == 1 else np.stack([y] * channels, 1).ravel()
        f.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


def _run(code: str, *args, timeout=120) -> str:
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _outside_drain(text: str) -> str:
    """decode.cc without its `drain_swr` lambda (and the comment above
    it): the one part of the port's copy that differs."""
    start = text.index("  auto drain_swr")
    start = text.rfind("\n\n", 0, start) + 2
    return text[:start] + text[text.index("  };\n", start) + 5:]


def test_sources_are_copies():
    """bigfile.cc is a byte-equal copy; decode.cc is one everywhere but
    in its resampler drain (`drain_swr`), the repair
    test_read_audio_resamples_without_cuts shows."""
    port = build.NATIVE.joinpath("bigfile.cc").read_bytes()
    assert port == (ROOT / "native" / "bigfile.cc").read_bytes()
    port = build.NATIVE.joinpath("decode.cc").read_text()
    jax_src = (ROOT / "native" / "decode.cc").read_text()
    assert port != jax_src
    assert _outside_drain(port) == _outside_drain(jax_src)
    assert "swr_convert(swr, dst, room, in, in_count)" in port


@needs_gxx
def test_status_names_both_builds():
    status = native.native_status()
    assert native.native_available()["bigfile"]
    for name in ("bigfile", "decode"):
        if status[name] is not None:
            assert Path(status[name]).parent.parent == build.BUILD_ROOT
    assert (status["libav"] == "found") == (status["decode"] is not None)
    log = (Path(status["bigfile"]).parent / "build.log").read_text()
    assert "-O3 -fPIC -shared -std=c++17" in log and "-lpthread" in log


@needs_libav
def test_port_never_maps_the_jax_libraries(tmp_path):
    """A process that decodes and gathers through the port maps only the
    port's libraries, never the JAX package's committed ones."""
    path = tmp_path / "v.avi"
    write_raw_avi(str(path), _frames(1, (4, 16, 16, 3)))
    code = (
        "import sys\n"
        "from cross_modal_video_engine_tpu_torch.io import native\n"
        "r = native.NativeVideoReader(sys.argv[1]); r.get_batch([0, 1])\n"
        "assert r.is_native and native.native_available()['bigfile']\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libcmve_decode.so' in maps and 'libcmve_bigfile.so' in maps\n"
        "assert 'cross_modal_video_engine_tpu/io/_native' not in maps\n"
        "assert 'cross_modal_video_engine_tpu.' not in ' '.join(sys.modules)\n"
        "print('ok')\n")
    assert _run(code, path).strip() == "ok"


@needs_libav
def test_concurrent_first_build(tmp_path):
    """Four processes start the first build of both libraries into one
    empty build directory at once: each loads a whole library and uses
    it, and each library is compiled exactly once (the lock)."""
    go = tmp_path / "go"
    code = (
        "import sys, time, numpy as np\n"
        "from pathlib import Path\n"
        "from cross_modal_video_engine_tpu_torch.io import _native_build as b\n"
        "b.BUILD_ROOT = Path(sys.argv[1])\n"
        "while not Path(sys.argv[2]).exists(): time.sleep(0.01)\n"
        "bf, vd = b.load_host_lib('bigfile'), b.load_host_lib('decode')\n"
        "assert vd.lib.vd_open and bf.lib.bf_gather\n"
        "print(int(bf.built), int(vd.built))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build"), str(go)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    go.touch()
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = np.array([list(map(int, o.split())) for o, _ in outs])
    assert built.sum(0).tolist() == [1, 1]
    libs = sorted(p.name for p in (tmp_path / "build").glob("*/*.so"))
    assert libs == ["libcmve_bigfile.so", "libcmve_decode.so"]
    assert not list((tmp_path / "build").glob("*/*.tmp"))


@needs_gxx
def test_missing_libav_is_a_verdict_not_a_failure(tmp_path):
    """Where the probe cannot link libav the decoder is not built:
    `native_available()` says False, `native_status()` says why, the
    reader takes the JAX fallback (cv2), read_audio gives None; the
    gather still builds."""
    path = tmp_path / "v.mp4"
    frames = _frames(2, (6, 32, 48, 3))
    write_test_video(str(path), frames)
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from cross_modal_video_engine_tpu_torch.io import _native_build as b\n"
        "b.BUILD_ROOT = Path(sys.argv[2])\n"
        "b.LIBAV = b.LIBAV + ('-lcmve_no_such_library',)\n"
        "from cross_modal_video_engine_tpu_torch.io import native\n"
        "st = native.native_status()\n"
        "r = native.NativeVideoReader(sys.argv[1])\n"
        "print(json.dumps([native.native_available(), st['libav'],\n"
        "                  st['decode'], r.is_native, len(r),\n"
        "                  native.read_audio(sys.argv[1]) is None]))\n")
    import json
    avail, verdict, decode, is_native, n, no_audio = json.loads(
        _run(code, path, tmp_path / "build"))
    assert avail == {"bigfile": True, "decode": False}
    assert "cmve_no_such_library" in verdict and decode is None
    assert not is_native and n == 6 and no_audio


@needs_gxx
def test_build_failure_raises_with_the_log(tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    (src / "bigfile.cc").write_text("int broken( {\n")
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from cross_modal_video_engine_tpu_torch.io import _native_build as b\n"
        "b.NATIVE, b.BUILD_ROOT = Path(sys.argv[1]), Path(sys.argv[2])\n"
        "try:\n"
        "    b.load_host_lib('bigfile')\n"
        "except RuntimeError as e:\n"
        "    print(str(e))\n")
    out = _run(code, src, tmp_path / "build")
    assert "g++ failed building libcmve_bigfile.so" in out
    assert "bigfile.cc" in out and "error" in out
    assert not list((tmp_path / "build").glob("*/*.so"))


@needs_gxx
def test_bigfile_gather_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    names = [f"v{i}" for i in range(60)]
    mat = rng.standard_normal((60, 24)).astype(np.float32)
    d = str(tmp_path / "bf")
    write_bigfile(d, names, mat)
    port, ref = native.NativeBigFile(d, n_threads=3), jnative.NativeBigFile(d)
    assert port.is_native and port.shape() == (60, 24) and "v7" in port
    sel = ["v7", "v3", "v59", "v7"]
    np.testing.assert_array_equal(port.read_batch(sel), ref.read_batch(sel))
    np.testing.assert_array_equal(port.read_one("v0"), mat[0])
    rows = rng.integers(0, 60, 700)
    np.testing.assert_array_equal(port.gather_rows(rows), mat[rows])
    np.testing.assert_array_equal(port.gather_rows(rows),
                                  ref.gather_rows(rows))
    port.close()
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def mp4s(tmp_path_factory):
    """Three cv2-written mp4s of seeded frames (the last 120 frames long,
    so a late index takes the keyframe seek)."""
    d = tmp_path_factory.mktemp("mp4")
    paths = []
    for i, shape in enumerate([(25, 48, 64, 3), (12, 40, 60, 3),
                               (120, 48, 64, 3)]):
        paths.append(str(d / f"v{i}.mp4"))
        write_test_video(paths[-1], _frames(10 + i, shape))
    return paths


@needs_libav
@pytest.mark.parametrize("out_size", [None, (32, 24), (96, 80)])
def test_decoder_bit_equal_to_jax_on_mp4(mp4s, out_size):
    """get_batch with repeated and unsorted indices, at native size and
    through the fused swscale resize (shrinking and growing)."""
    for path, idx in zip(mp4s, ([0, 5, 10, 24, 5], [11, 0, 3, 3],
                                [100, 110, 119, 2, 100])):
        port, ref = native.NativeVideoReader(path), \
            jnative.NativeVideoReader(path)
        assert port.is_native and ref.is_native
        assert (len(port), port.width, port.height, port.fps) == \
            (len(ref), ref.width, ref.height, ref.fps)
        got = port.get_batch(idx, out_size)
        np.testing.assert_array_equal(got, ref.get_batch(idx, out_size))
        if out_size:
            assert got.shape[1:3] == (out_size[1], out_size[0])
        port.release()
        port.release()
        ref.release()


@needs_libav
def test_decode_batch_bit_equal_with_a_missing_video(mp4s, tmp_path):
    paths = [mp4s[0], str(tmp_path / "missing.mp4"), mp4s[2]]
    idx = np.array([[0, 7, 7, 24], [0, 1, 2, 3], [119, 3, 60, 60]])
    got = native.decode_videos_batch(paths, idx, out_w=40, out_h=30,
                                     n_threads=3)
    want = jnative.decode_videos_batch(paths, idx, out_w=40, out_h=30)
    assert got.shape == (3, 4, 30, 40, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[0].any() and got[2].any()


@needs_libav
def test_raw_avi_reads_back_exactly(tmp_path):
    """The uncompressed AVI fixture (odd width: padded rows) decodes to
    its source frames, by both packages' decoders, and through the fused
    resize both give the same pixels."""
    frames = _frames(4, (30, 37, 53, 3))
    path = str(tmp_path / "raw.avi")
    write_raw_avi(path, frames)
    idx = [0, 5, 29, 7, 5]
    port, ref = native.NativeVideoReader(path), \
        jnative.NativeVideoReader(path)
    assert (len(port), port.width, port.height) == (30, 53, 37)
    np.testing.assert_array_equal(port.get_batch(idx), frames[idx])
    np.testing.assert_array_equal(ref.get_batch(idx), frames[idx])
    np.testing.assert_array_equal(port.get_batch(idx, (24, 16)),
                                  ref.get_batch(idx, (24, 16)))
    batch = native.decode_videos_batch([path, path], np.array([idx, idx]),
                                       24, 16)
    np.testing.assert_array_equal(batch[1], ref.get_batch(idx, (24, 16)))


@needs_libav
def test_fps_is_cv2s_and_30_without_cv2(mp4s):
    """The native reader's fps is cv2's probe, as in the JAX package, and
    30.0 in a process where cv2 cannot be imported."""
    import cv2
    cap = cv2.VideoCapture(mp4s[0])
    assert native.NativeVideoReader(mp4s[0]).fps == cap.get(
        cv2.CAP_PROP_FPS) == 10.0
    code = ("import sys; sys.modules['cv2'] = None\n"
            "from cross_modal_video_engine_tpu_torch.io import native\n"
            "r = native.NativeVideoReader(sys.argv[1])\n"
            "print(r.fps, r.is_native)\n")
    assert _run(code, mp4s[0]).split() == ["30.0", "True"]


def _sine_error(y, rate, freq=440.0, amp=0.4, edge=32) -> float:
    t = np.arange(len(y)) / rate
    return float(np.abs(y - amp * np.sin(2 * np.pi * freq * t))
                 [edge:-edge].max())


@needs_libav
def test_read_audio_matches_jax_without_resampling(tmp_path):
    """Stereo 8 kHz WAV -> mono (the channel mean) at 8 kHz: bit-equal to
    the JAX package's, and the sine within 1e-3; a video without audio
    gives None in both."""
    sr = 8000
    t = np.arange(sr) / sr
    y = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = str(tmp_path / "s.wav")
    write_wav(path, y, sr, channels=2)
    got = native.read_audio(path, sr)
    np.testing.assert_array_equal(got, jnative.read_audio(path, sr))
    np.testing.assert_allclose(got[:sr], y, atol=1e-3)
    video = str(tmp_path / "v.avi")
    write_raw_avi(video, _frames(5, (4, 16, 16, 3)))
    assert native.read_audio(video) is None
    assert jnative.read_audio(video) is None


@needs_libav
@pytest.mark.parametrize("src,rate", [(44100, 16000), (8000, 16000),
                                      (16000, 22050)])
def test_read_audio_resamples_without_cuts(tmp_path, src, rate):
    """Resampled audio stays on the sine within 1e-3 (past the first and
    last 32 samples, the resampler's edges): the port's drain feeds each
    decoded frame once and takes swr's buffered output without flushing.
    The JAX package's decoder flushes swr after every frame, so its
    output restarts at each frame boundary and leaves the sine by more
    than 0.1 (the fault the port's copy of decode.cc repairs)."""
    t = np.arange(2 * src) / src
    path = str(tmp_path / "s.wav")
    write_wav(path, 0.4 * np.sin(2 * np.pi * 440 * t), src, channels=2)
    got = native.read_audio(path, rate)
    assert abs(len(got) - 2 * rate) <= 32
    assert _sine_error(got, rate) < 1e-3
    assert _sine_error(jnative.read_audio(path, rate), rate) > 0.1


@needs_libav
def test_decoder_writes_nothing_past_its_buffer(tmp_path):
    """The staging copy behind swscale: a canary-padded buffer at an
    unaligned stride (88 * 3 = 264 bytes a row) keeps its canary."""
    path = str(tmp_path / "canary.mp4")
    write_test_video(path, _frames(6, (60, 72, 88, 3)))
    lib = native._vd()
    info = np.zeros(3, np.int32)
    h = lib.vd_open(path.encode(), info.ctypes.data)
    assert h
    w, ht = int(info[1]), int(info[2])
    idx = np.ascontiguousarray([0, 30, 59, 10], np.int64)
    nbytes = len(idx) * ht * w * 3
    buf = np.full(nbytes + 4096, 0xAB, np.uint8)
    rc = lib.vd_decode(h, idx.ctypes.data, len(idx), buf.ctypes.data, w, ht)
    lib.vd_close(h)
    assert rc == 0
    assert (buf[nbytes:] == 0xAB).all()
