"""ctypes bindings for the native (C++) host IO layer.

Counterpart of cross_modal_video_engine_tpu/io/native.py.  The port
builds its own copy of the C++ sources (`native/decode.cc`,
`native/bigfile.cc`) with g++ on first use (io/_native_build.py) and
never loads the JAX package's libraries.  The ctypes signatures and the
contracts are the JAX package's (read_audio's resampled output is not:
the port's decode.cc repairs the resampler drain, see
io/_native_build.py):

  * NativeBigFile -> io.bigfile.BigFile (numpy memmap) where the file
    does not open natively;
  * NativeVideoReader -> io.video_decode.CvVideoReader (cv2) where libav
    was not found or the file does not open; on a machine without cv2
    that fallback raises ImportError naming cv2, so nothing passes for a
    decode;
  * read_audio -> None where libav was not found or the file has no
    audio stream;
  * decode_videos_batch -> the per-video reader and cv2's resize.

The bigfile library always builds (a g++ failure raises); the decode
library builds only where the libav probe succeeds, and
`native_status()` says why not where it fails.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np

from ._native_build import libav_probe, load_decoder, load_host_lib


@functools.cache
def _bf() -> ctypes.CDLL:
    lib = load_host_lib("bigfile").lib
    lib.bf_open.restype = ctypes.c_void_p
    lib.bf_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.bf_gather.restype = ctypes.c_int
    lib.bf_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.bf_close.argtypes = [ctypes.c_void_p]
    return lib


@functools.cache
def _vd() -> Optional[ctypes.CDLL]:
    """The decode library, or None where the libav probe failed."""
    host = load_decoder()
    if host is None:
        return None
    lib = host.lib
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.vd_decode.restype = ctypes.c_int
    lib.vd_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.ad_duration.restype = ctypes.c_double
    lib.ad_duration.argtypes = [ctypes.c_char_p]
    lib.ad_extract.restype = ctypes.c_int64
    lib.ad_extract.argtypes = [ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64]
    lib.vd_decode_batch.restype = ctypes.c_int
    lib.vd_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def native_available() -> dict:
    """{"bigfile": bool, "decode": bool}; builds what is not built yet."""
    return {"bigfile": _bf() is not None, "decode": _vd() is not None}


def native_status() -> dict:
    """The build of both libraries and the libav probe's verdict:
    {"bigfile": path, "decode": path or None, "libav": "found" or why not,
    "seconds": {...}} (builds what is not built yet)."""
    probe = libav_probe()
    bf = load_host_lib("bigfile")
    vd = load_decoder()
    return {"bigfile": str(bf.path), "decode": vd and str(vd.path),
            "libav": "found" if probe.found else probe.reason,
            "built": {"bigfile": bf.built, "decode": vd and vd.built},
            "seconds": {"probe": probe.seconds, "bigfile": bf.seconds,
                        "decode": vd and vd.seconds}}


class NativeBigFile:
    """Drop-in for io.bigfile.BigFile backed by the C++ mmap gather."""

    def __init__(self, datadir: str, n_threads: int = 4):
        with open(os.path.join(datadir, "shape.txt")) as f:
            self.nr_of_images, self.ndims = map(int, f.readline().split())
        with open(os.path.join(datadir, "id.txt")) as f:
            self.names = f.read().split()
        self.name2index = {n: i for i, n in enumerate(self.names)}
        self.n_threads = n_threads
        self._lib = _bf()
        self._handle = self._lib.bf_open(
            os.path.join(datadir, "feature.bin").encode(),
            self.nr_of_images, self.ndims)
        if not self._handle:
            from .bigfile import BigFile
            self._fallback = BigFile(datadir)
        else:
            self._fallback = None

    @property
    def is_native(self) -> bool:
        return self._fallback is None

    def read_batch(self, requested: Sequence[str]) -> np.ndarray:
        if self._fallback is not None:
            return self._fallback.read_batch(requested)
        rows = np.asarray([self.name2index[n] for n in requested], np.int64)
        return self.gather_rows(rows)

    def gather_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = np.ascontiguousarray(rows, np.int64)
        out = np.empty((len(rows), self.ndims), np.float32)
        rc = self._lib.bf_gather(self._handle, rows.ctypes.data, len(rows),
                                 out.ctypes.data, self.n_threads)
        if rc != 0:
            raise RuntimeError(f"bf_gather failed rc={rc}")
        return out

    def read_one(self, name: str) -> np.ndarray:
        return self.read_batch([name])[0]

    def shape(self):
        return (self.nr_of_images, self.ndims)

    def __contains__(self, name: str) -> bool:
        return name in self.name2index

    def close(self):
        if self._handle:
            self._lib.bf_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeVideoReader:
    """Drop-in for io.video_decode.CvVideoReader backed by libav."""

    def __init__(self, path: str):
        self.path = path
        self._handle = None
        self._fallback = None
        self._lib = _vd()
        if self._lib is not None:
            info = np.zeros(3, np.int32)
            self._handle = self._lib.vd_open(path.encode(), info.ctypes.data)
            if self._handle:
                self._n, self.width, self.height = (int(info[0]),
                                                    int(info[1]),
                                                    int(info[2]))
        if self._handle:
            # the native info array has no fps; probe it with cv2 so
            # the CvVideoReader interface contract (DecordInit reads
            # .fps) holds on both paths; 30.0 where cv2 is missing
            try:
                import cv2
                cap = cv2.VideoCapture(path)
                self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                cap.release()
            except Exception:
                self.fps = 30.0
        else:
            from .video_decode import CvVideoReader
            self._fallback = CvVideoReader(path)
            self._n = len(self._fallback)
            self.width = self._fallback.width
            self.height = self._fallback.height
            self.fps = self._fallback.fps

    @property
    def is_native(self) -> bool:
        return self._fallback is None

    def __len__(self) -> int:
        return self._n

    def get_batch(self, indices: Sequence[int],
                  out_size: Optional[tuple] = None) -> np.ndarray:
        """Decode frames; optionally fused resize to out_size=(w, h)."""
        if self._fallback is not None:
            frames = self._fallback.get_batch(indices)
            if out_size and (out_size[0] != self.width
                             or out_size[1] != self.height):
                # honor out_size on the fallback path too: behavior
                # must not depend on whether the native lib is built
                import cv2
                frames = np.stack([cv2.resize(f, tuple(out_size))
                                   for f in frames])
            return frames
        idx = np.ascontiguousarray(indices, np.int64)
        w = out_size[0] if out_size else self.width
        h = out_size[1] if out_size else self.height
        out = np.empty((len(idx), h, w, 3), np.uint8)
        rc = self._lib.vd_decode(self._handle, idx.ctypes.data, len(idx),
                                 out.ctypes.data, w, h)
        if rc != 0:
            raise IOError(f"vd_decode failed rc={rc} for {self.path}")
        return out

    def release(self):
        if self._handle:
            self._lib.vd_close(self._handle)
            self._handle = None
        if self._fallback is not None:
            self._fallback.release()

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


def read_audio(path: str, sample_rate: int = 16000
               ) -> Optional[np.ndarray]:
    """Decode a container's audio stream to mono float32 at `sample_rate`
    (in-process replacement for the reference's `ffmpeg -map 0:a` shell
    call, MCT/tools/data/extract_audio.py:21).  Returns None when libav
    was not found or the file has no audio stream."""
    lib = _vd()
    if lib is None:
        return None
    secs = lib.ad_duration(os.fsencode(path))
    if secs <= 0:
        secs = 600.0  # unknown duration: cap at 10 minutes
    max_samples = int(secs * sample_rate) + sample_rate
    out = np.empty((max_samples,), np.float32)
    n = lib.ad_extract(os.fsencode(path), sample_rate,
                       out.ctypes.data_as(ctypes.c_void_p), max_samples)
    if n < 0:
        return None
    return out[:n].copy()


def decode_videos_batch(paths: Sequence[str], indices: np.ndarray,
                        out_w: int, out_h: int,
                        n_threads: int = 8) -> np.ndarray:
    """Decode a BATCH of videos into one (B, T, out_h, out_w, 3) uint8
    array: the resize happens inside the decoder (swscale), and the whole
    batch is one ctypes call driving a C++ thread pool.

    indices: (B, T) int64 frame indices per video.  Falls back to the
    per-video reader (cv2) where libav was not found.  Failed videos
    come back as zeros (matching vd_decode_batch).
    """
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    B, T = indices.shape
    assert len(paths) == B
    out = np.empty((B, T, out_h, out_w, 3), np.uint8)
    lib = _vd()
    if lib is not None:
        c_paths = (ctypes.c_char_p * B)(
            *[os.fsencode(p) for p in paths])
        lib.vd_decode_batch(
            c_paths, indices.ctypes.data_as(ctypes.c_void_p), T, B,
            out.ctypes.data_as(ctypes.c_void_p), out_w, out_h, n_threads)
        return out
    # fallback: per-video decode + host resize
    from .video_decode import open_video
    for i, p in enumerate(paths):
        try:
            reader = open_video(p)
            frames = reader.get_batch(list(indices[i]))
            reader.release()
            if frames.shape[1:3] != (out_h, out_w):
                import cv2
                frames = np.stack([
                    cv2.resize(f, (out_w, out_h),
                               interpolation=cv2.INTER_LINEAR)
                    for f in frames])
            out[i] = frames
        except Exception:
            out[i] = 0
    return out
