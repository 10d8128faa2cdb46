"""Build the port's host C++ sources with g++ and load them with ctypes.

The sources in `native/` (the libav video and audio decoder `decode.cc`
and the mmap row gather `bigfile.cc`) are plain C++ with a C interface,
copies of the JAX package's native/*.cc.  `bigfile.cc` is byte-equal;
`decode.cc` differs in one place, the resampler drain of `ad_extract`:
the JAX package's flushes swr after every decoded frame, which restarts
the resampling filter there and cuts resampled audio at each frame
boundary; the port's feeds each frame once and takes what swr buffers
without a flush (the end of the stream flushes once).

Each is compiled on first use with the compile and link lines of the JAX
package's native/Makefile into `build/native/<hash>/` at the root of the
checkout, keyed by a hash of the source and the command, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time.

`bigfile.cc` needs no library and always builds; a g++ failure raises
with the compiler's output.  `decode.cc` links libav (libavformat,
libavcodec, libavutil, libswscale, libswresample).  Whether this machine
has libav is decided by a probe first: a one-line program that includes
the five headers and links the five libraries.  Where the probe fails the
decoder is not built, `libav_probe()` says why, and a caller takes its
fallback; where the probe succeeds a build failure raises.

Several processes may build at once (parallel test workers): each build
holds an `fcntl` lock on its directory and writes the library under a
temporary name, then `os.replace`s it into place, so no process loads a
half-written library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBAV = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample")
# source -> (library, link line) as native/Makefile has them
LIBS = {"bigfile": ("libcmve_bigfile.so", ("-lpthread",)),
        "decode": ("libcmve_decode.so", LIBAV + ("-lpthread",))}
PROBE = """extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}
int main() { return avformat_version() == 0 || swscale_version() == 0; }
"""


@dataclasses.dataclass(frozen=True)
class HostLib:
    """A loaded host library and what its build cost (the g++ command
    and its output are in `build.log` beside it)."""

    lib: ctypes.CDLL
    path: Path
    built: bool             # False when an earlier build was loaded
    seconds: float          # build (or load) wall time


@dataclasses.dataclass(frozen=True)
class Probe:
    """Whether libav's headers and libraries were found, and why not."""

    found: bool
    reason: str             # "" when found, else the compiler's complaint
    seconds: float


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("g++ not found: the host libraries (native/*.cc) "
                           "are compiled on first use; put g++ on PATH or "
                           "set CXX")
    return cxx


def _command(cxx: str, src: Path, out: Path, links) -> list:
    return [cxx, *CXX_FLAGS, "-o", str(out), str(src), *links]


@functools.cache
def libav_probe() -> Probe:
    """Compile and link the one-line libav program (once per process)."""
    t0 = time.perf_counter()
    try:
        cxx = _cxx()
    except RuntimeError as e:
        return Probe(False, str(e), time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="cmve_libav_probe_") as tmp:
        src = Path(tmp) / "probe.cc"
        src.write_text(PROBE)
        cmd = [cxx, "-std=c++17", "-o", str(Path(tmp) / "probe"), str(src),
               *LIBAV]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode == 0:
        return Probe(True, "", time.perf_counter() - t0)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    why = next((line for line in lines if "error" in line), None)
    reason = ("libav not found: `" + " ".join(cmd[:1] + list(LIBAV)) + "` "
              + "failed: " + (why or (lines[-1] if lines else "no output")))
    return Probe(False, reason, time.perf_counter() - t0)


def _key(src: Path, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_host_lib(name: str) -> HostLib:
    """Build (once per hash of source and command) and load one library
    of `native/`: "bigfile" or "decode".  Raises RuntimeError with the
    compiler's output where g++ fails."""
    t0 = time.perf_counter()
    lib_name, links = LIBS[name]
    src = NATIVE / f"{name}.cc"
    cxx = _cxx()
    out_dir = BUILD_ROOT / _key(src, _command(Path(cxx).name, src,
                                              Path(lib_name), links))
    so = out_dir / lib_name
    built = False
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)       # one build at a time
            if not so.is_file():       # unless another process built it
                built = True
                tmp = out_dir / f".{lib_name}.{os.getpid()}.tmp"
                cmd = _command(cxx, src, tmp, links)
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed building {lib_name}:\n"
                                       f"{log}")
                (out_dir / "build.log").write_text(log)
                os.replace(tmp, so)        # atomic: no half-written library
    return HostLib(lib=ctypes.CDLL(str(so)), path=so, built=built,
                   seconds=time.perf_counter() - t0)


def load_decoder() -> Optional[HostLib]:
    """The decode library where the probe found libav, else None."""
    return load_host_lib("decode") if libav_probe().found else None
