"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources in `csrc/` have a plain C interface, so they compile in
seconds with nvcc alone (no PyTorch headers) into one shared library for
Hopper (`sm_90a`).  The build runs on first use, into
`build/kernels/<hash>/` at the root of the checkout, keyed by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libcmve_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# (name, restype, argtypes) of every C entry in csrc/
_SIGNATURES = (
    ("cmve_layernorm", _I, [_I, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P]),
    ("cmve_gemm", _I,
     [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
      _P]),
    ("cmve_attention_core", _I,
     [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
      _P]),
)


@dataclasses.dataclass(frozen=True)
class Kernels:
    """The loaded library, with what its build cost and reported."""

    lib: ctypes.CDLL
    path: Path
    built: bool             # False when an earlier build was loaded
    seconds: float          # build (or load) wall time
    log: str                # nvcc/ptxas output: registers, spills, smem


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME / CUDA_PATH, else from the
    toolkit PyTorch itself located."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA sublayer kernels are compiled on first "
        "use; put the CUDA toolkit's nvcc on PATH or set CUDA_HOME")


def _compile(out_dir: Path, sources) -> str:
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sources if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {LIB_NAME}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out_dir / LIB_NAME)   # atomic: no half-written library
    log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(log)
    return log


@functools.cache
def load_kernels() -> Kernels:
    """Build (once per source hash) and load the CUDA library."""
    t0 = time.perf_counter()
    sources = _sources()
    out_dir = BUILD_ROOT / _key(sources)
    so = out_dir / LIB_NAME
    built = not so.is_file()
    if built:
        log = _compile(out_dir, sources)
    else:
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.is_file() else ""
    lib = ctypes.CDLL(str(so))
    for name, restype, argtypes in _SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return Kernels(lib=lib, path=so, built=built,
                   seconds=time.perf_counter() - t0, log=log)
