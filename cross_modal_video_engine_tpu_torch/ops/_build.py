"""Build the port's CUDA sources with nvcc and load them with ctypes.

The sources in `csrc/` have a plain C interface, so they compile in
seconds with nvcc alone (no PyTorch headers) into one shared library for
Hopper (`sm_90a`): one nvcc per source, all started together, then one
link.  The build runs on first use, into
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libcmve_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (name, restype, argtypes) of every C entry in csrc/
_SIGNATURES = (
    # (dtype, dtype of scale and bias, x, scale, bias, out, M, K, eps,
    #  stream)
    ("cmve_layernorm", _I, [_I, _I, _P, _P, _P, _P, _I, _I, _F, _P]),
    ("cmve_gemm", _I,
     [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
      _P]),
    ("cmve_attention_core", _I,
     [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    # (dtype, dtype of the LayerNorm scale and bias, x, 10 parameters,
    #  workspace, y, n, D, heads, seq_stride, rows, valid_len, causal, eps,
    #  scale, stream)
    ("cmve_attention_sublayer", _I,
     [_I, _I] + [_P] * 13 + [_I] * 7 + [_F, _F, _P]),
    # (dtype, dtype of the LayerNorm scale and bias, x, 6 parameters,
    #  workspace, y, n, D, hidden, eps, stream)
    ("cmve_mlp_sublayer", _I, [_I, _I] + [_P] * 9 + [_I] * 3 + [_F, _P]),
    # (dtype, q, k, v, o, B, H, Sq, Skv, hd, int64[12] strides, scale,
    #  causal, stream)
    ("cmve_flash_attention", _I,
     [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
      ctypes.POINTER(ctypes.c_longlong), _F, _I, _P]),
    # (dtype, n, D, heads, hidden, seq_len) -> bytes of scratch, -1: refused
    ("cmve_block_scratch_bytes", ctypes.c_longlong, [_I] * 6),
    # (dtype, x, 16 parameters, y, scratch, n, D, heads, hidden, seq_len,
    #  causal, eps, scale, stream)
    ("cmve_block_sublayer", _I,
     [_I] + [_P] * 19 + [_I] * 6 + [_F, _F, _P]),
    # (a, b, v: (64, 64) bf16; d1 = a b^T, d2 = bf16(d1) v: (64, 64) f32;
    #  stream)
    ("cmve_wgmma_selfcheck", _I, [_P] * 6),
    # (a: (64, 64), k, v: (2, 80, 64) bf16 read through 3-D maps bounded at
    #  77 rows; d1 = a k[1]^T: (64, 80), d2 = bf16(d1) v[1]: (64, 64) f32;
    #  stream)
    ("cmve_wgmma_selfcheck_keys", _I, [_P] * 6),
    # (a: (64, 64), b: (192, 128) bf16; d1 = a b[:, 64:]^T: (64, 192) and
    #  d2 = a b[32:64, 64:]^T: (64, 32) f32; stream)
    ("cmve_wgmma_selfcheck_block", _I, [_P] * 5),
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


def _key(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
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
        "nvcc not found: the CUDA kernels are compiled on first use; put "
        "the CUDA toolkit's nvcc on PATH or set CUDA_HOME")


def _compile(out_dir: Path, sources, flags) -> str:
    """One nvcc per .cu, run in parallel, then one link into the library;
    returns the compilers' output (ptxas registers, spills, smem)."""
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        jobs = []
        for src in (p for p in sources if p.suffix == ".cu"):
            cmd = [nvcc, *flags, "-I", str(CSRC), "-c", str(src),
                   "-o", str(tmp / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = "", []
        for cmd, proc in jobs:
            out = proc.communicate()[0]
            log += f"$ {' '.join(cmd)}\n{out}"
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed building "
                               f"{LIB_NAME}:\n" + "\n".join(failed))
        so = tmp / LIB_NAME
        cmd = [nvcc, "-shared", "-o", str(so),
               *sorted(str(o) for o in tmp.glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {LIB_NAME}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so, out_dir / LIB_NAME)   # atomic: no half-written library
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (out_dir / "build.log").write_text(log)
    return log


@functools.cache
def load_kernels(defines: tuple = ()) -> Kernels:
    """Build (once per hash of sources and flags) and load the CUDA
    library.  `defines` are extra `-D...` flags of an instrumented build
    (see block_sublayer.cu); the package itself passes none."""
    t0 = time.perf_counter()
    sources = _sources()
    flags = (*NVCC_FLAGS, *defines)
    out_dir = BUILD_ROOT / _key(sources, flags)
    so = out_dir / LIB_NAME
    built = not so.is_file()
    if built:
        log = _compile(out_dir, sources, flags)
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
