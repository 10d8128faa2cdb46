"""The msgpack form of flax.serialization, read and written without msgpack.

The JAX package writes a checkpoint's variables with
`flax.serialization.to_bytes`: msgpack maps with string keys, leaves as
msgpack extension types whose payload is itself msgpack:

* type 1, an array: `[shape, dtype name, raw C-order bytes]`;
* type 2, a Python complex: `[real, imag]`;
* type 3, a numpy scalar: an array payload of shape `[]`.

Arrays of more than `MAX_CHUNK_SIZE` bytes are split into a dict
`{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": flat part, ...}}`.  Lists and tuples become dicts keyed "0", "1", ...
(flax's state dict of a sequence).

`to_bytes(tree)` gives the bytes `flax.serialization.to_bytes` gives for the
same tree, keys in the tree's own order; `restore(data)` reads them back
with every array as a CPU torch tensor (bfloat16, which numpy lacks, as
uint16 bits viewed as torch.bfloat16) and reassembles chunked arrays.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30                  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# -- encoder ---------------------------------------------------------------

def _pack_int(out: List[bytes], n: int) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack("b", n))
    elif 0xFF < n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif -0x8000 <= n < -0x80:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif -0x80000000 <= n < -0x8000:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int,
              heads: Tuple[bytes, ...], sizes: Tuple[str, ...]) -> None:
    """The header of a str/bin/array/map of n items: a fix form below
    fix_max (fix=None: none), else the first head whose size holds n."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for head, fmt in zip(heads, sizes):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(head + struct.pack(">" + fmt, n))
            return
    raise OverflowError(f"{n} items do not fit msgpack")


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"),
              ("B", "H", "I"))
    out.append(b)


def _pack_bin(out: List[bytes], b: bytes) -> None:
    _pack_len(out, len(b), None, 0, (b"\xc4", b"\xc5", b"\xc6"),
              ("B", "H", "I"))
    out.append(b)


def _pack_ext(out: List[bytes], code: int, *payload) -> None:
    """An extension of the given type whose payload is the parts given,
    each bytes-like (an array's raw bytes go in without a copy)."""
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    n = sum(memoryview(p).nbytes for p in payload)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (b"\xc7", b"\xc8", b"\xc9"),
                  ("B", "H", "I"))
    out.append(struct.pack("b", code))
    out.extend(payload)


def _array_head(shape, dtype_name: str, nbytes: int) -> bytes:
    """An array payload up to its raw bytes: [shape, dtype name, bin
    header]."""
    out: List[bytes] = []
    _pack_len(out, 3, 0x90, 16, (), ())
    _pack_len(out, len(shape), 0x90, 16, (b"\xdc", b"\xdd"), ("H", "I"))
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, dtype_name)
    _pack_len(out, nbytes, None, 0, (b"\xc4", b"\xc5", b"\xc6"),
              ("B", "H", "I"))
    return b"".join(out)


def _as_numpy(x) -> Tuple[np.ndarray, str]:
    """An array leaf as (C-order numpy array, dtype name); a bfloat16
    tensor as its uint16 bits with the name 'bfloat16'."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return x, x.dtype.name


def _pack_array(out: List[bytes], x, code: int = EXT_NDARRAY) -> None:
    a, name = _as_numpy(x)
    # the C-order bytes as a view (a copy only where a is not C-contiguous)
    raw = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    _pack_ext(out, code, _array_head(a.shape, name, raw.nbytes), raw)


def _chunk(x) -> Dict[str, Any]:
    """flax's chunked form of an array past MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + step] for j, i in
                       enumerate(range(0, flat.shape[0], step))}}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _pack(out: List[bytes], x) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        _pack_array(out, x)
    elif isinstance(x, np.generic):
        _pack_array(out, np.asarray(x), EXT_NPSCALAR)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is complex:
        body: List[bytes] = []
        _pack_len(body, 2, 0x90, 16, (), ())
        for part in (x.real, x.imag):
            body.append(b"\xcb" + struct.pack(">d", part))
        _pack_ext(out, EXT_COMPLEX, b"".join(body))
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (b"\xde", b"\xdf"), ("H", "I"))
        for k, v in x.items():
            _pack_str(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _state_dict(x):
    """flax's to_state_dict: string keys, sequences as index-keyed dicts,
    arrays past MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(x, dict):
        keys = [str(k) for k in x]
        if len(set(keys)) != len(keys):
            raise ValueError(f"keys without unique strings: {list(x)}")
        out = {}
        for k, v in x.items():
            v = _state_dict(v)
            if (isinstance(v, (torch.Tensor, np.ndarray))
                    and _nbytes(v) > MAX_CHUNK_SIZE):
                v = _chunk(v)
            out[str(k)] = v
        return out
    if isinstance(x, (list, tuple)):
        return _state_dict({str(i): v for i, v in enumerate(x)})
    return x


def to_bytes(tree) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` writes for a tree of
    dicts, lists and tuples over numpy arrays, torch tensors, numpy
    scalars and Python scalars."""
    tree = _state_dict(tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# -- decoder ---------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt,
                             self.take(struct.calcsize(">" + fmt)))[0]


_FIXED_EXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SIZED = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
          0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I")}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}


def _array_from(shape, name: str, raw: memoryview) -> torch.Tensor:
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    a = np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()
    return torch.from_numpy(a)


def _ext(code: int, payload: memoryview):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, name, raw = _decode(_Reader(payload), views=True)
        return _array_from(tuple(shape), name, raw)
    if code == EXT_COMPLEX:
        real, imag = _decode(_Reader(payload))
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def _decode(r: _Reader, views: bool = False):
    """The next object; bin values as memoryviews into the data if
    `views` (an array payload's bytes), else as bytes."""
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, views) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXED_EXT:
        code = struct.unpack("b", r.take(1))[0]
        return _ext(code, r.take(_FIXED_EXT[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n) if views else bytes(r.take(n))
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "array":
            return [_decode(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        code = struct.unpack("b", r.take(1))[0]
        return _ext(code, r.take(n))
    raise ValueError(f"byte 0x{b:02x} starts no msgpack object")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _unchunk(x):
    if not isinstance(x, dict):
        return x
    if x.get(CHUNKED) is True:
        try:
            shape = [x["shape"][str(i)] for i in range(len(x["shape"]))]
            parts = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
        except KeyError as e:
            raise ValueError(f"malformed chunked array: no key {e}") from None
        return torch.cat([p.reshape(-1) for p in parts]).reshape(shape)
    return {k: _unchunk(v) for k, v in x.items()}


def restore(data) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` gives, with each
    array (and numpy scalar, as a 0-d tensor) a CPU torch tensor."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return _unchunk(tree)
