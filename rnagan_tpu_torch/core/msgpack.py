"""The msgpack subset that ``flax.serialization`` writes, in the standard library.

The JAX package's checkpoints (``rnagan_tpu/core/checkpoint.py``: the VAE's
``model_best.ckpt``, the GAN's ``gan_last.model``) are
``flax.serialization.msgpack_serialize`` of a state-dict tree. The port reads
and writes that format without ``msgpack`` or ``flax``:

* maps, arrays, str, bin, ints, floats, bool and nil as msgpack defines them;
* ext type 1: an ndarray, itself msgpack of ``(shape, dtype name, C-order
  bytes)`` (``flax/serialization.py::_ndarray_to_bytes``); ext type 2: a
  complex number as ``(real, imag)``; ext type 3: a numpy scalar, packed as a
  0-d ndarray;
* ``bfloat16`` arrays (numpy has no such dtype without JAX) are read as
  uint16 and returned as ``torch.bfloat16`` tensors; every other array is a
  read-only numpy view of the buffer, as flax returns it;
* an array over ``MAX_CHUNK_SIZE`` bytes is stored as a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat chunk, ...}}`` (msgpack caps one object at 2**31 - 1 bytes);
  :func:`unpackb` reassembles it and :func:`pack` writes it.

Writing mirrors flax: a tuple or list is a msgpack array, a numpy scalar
ext 3, an ndarray or tensor ext 1.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List

import numpy as np
import torch

#: flax's ``MAX_CHUNK_SIZE``: an array of more bytes is written in chunks
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ reading


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, data: memoryview):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from_bytes(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read(raw=False)
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")

    def read(self, raw: bool):
        """One object; ``raw`` (flax's inner ndarray header) leaves str as
        bytes and bin as a view of the buffer."""
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack((">B", ">H", ">I")[b - 0xC4]))
            return data if raw else bytes(data)  # raw: an array's buffer, not copied
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            code = self.unpack(">b")
            return self.ext(code, self.take(n))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack: byte 0x{b:02x} starts no object")

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool):
        out = {}
        for _ in range(n):
            key = self.read(raw)
            out[key] = self.read(raw)
        return _unchunk(out) if out.get(CHUNKED) is True else out


def _ndarray_from_bytes(data: memoryview):
    shape, dtype_name, buffer = _Reader(data).read(raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(shape)


def _unchunk(d):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data) -> Any:
    """``flax.serialization.msgpack_restore`` without flax: the tree with
    numpy leaves (``torch.bfloat16`` tensors for bfloat16 arrays)."""
    reader = _Reader(data)
    out = reader.read(raw=False)
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


# ------------------------------------------------------------------ writing


def _header(sizes, n: int) -> bytes:
    """The type byte and length of a str/bin/array/map/ext of length ``n``."""
    for (limit, code, fmt) in sizes:
        if n < limit:
            return bytes([code | n]) if fmt is None else bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: object of length {n} too large")


_STR = ((32, 0xA0, None), (1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARR = ((16, 0x90, None), (1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((16, 0x80, None), (1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    for fmt, code, lo, hi in ((">B", 0xCC, 0, 1 << 8), (">H", 0xCD, 0, 1 << 16),
                              (">I", 0xCE, 0, 1 << 32), (">Q", 0xCF, 0, 1 << 64),
                              (">b", 0xD0, -(1 << 7), 0), (">h", 0xD1, -(1 << 15), 0),
                              (">i", 0xD2, -(1 << 31), 0), (">q", 0xD3, -(1 << 63), 0)):
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(_STR, len(raw)) + raw


def _array_parts(arr) -> List[Any]:
    """The ext-1 payload of an ndarray or tensor, as parts: the header of
    ``(shape, dtype name, bytes)`` and the C-order data itself (not copied)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).removeprefix("torch.")
        data = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        shape = tuple(t.shape)
    else:
        a = np.asarray(arr)
        if not a.flags.c_contiguous:
            a = a.copy(order="C")  # (ascontiguousarray would make a 0-d array 1-d)
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise ValueError("msgpack: object and structured dtypes are not supported")
        name, data, shape = a.dtype.name, a, a.shape
    view = memoryview(data.reshape(-1)).cast("B")
    head = (_header(_ARR, 3) + _header(_ARR, len(shape)) + b"".join(_int(int(s)) for s in shape)
            + _str(name) + _header(_BIN, len(view)))
    return [head, view]


def _ext(code: int, parts) -> List[Any]:
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]]) + struct.pack(">b", code)
    else:
        head = _header(((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"), (1 << 32, 0xC9, ">I")), n)
        head += struct.pack(">b", code)
    return [head, *parts]


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(arr):
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def pack(obj: Any, write: Callable[[Any], Any]) -> None:
    """Write ``obj`` as msgpack through ``write`` (called with bytes-like
    parts; large arrays are passed as views, not copied). A dict value that
    is an array of more than ``MAX_CHUNK_SIZE`` bytes is written in chunks,
    as flax does."""
    if obj is None:
        write(b"\xc0")
    elif isinstance(obj, np.generic):  # before float: np.float64 subclasses it, and flax packs it as ext 3
        for part in _ext(_EXT_NPSCALAR, _array_parts(np.asarray(obj))):
            write(part)
    elif isinstance(obj, bool):
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, complex):
        inner: List[Any] = []
        pack((obj.real, obj.imag), inner.append)
        for part in _ext(_EXT_COMPLEX, inner):
            write(part)
    elif isinstance(obj, str):
        write(_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        write(_header(_BIN, len(obj)))
        write(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        write(_header(_ARR, len(obj)))
        for item in obj:
            pack(item, write)
    elif isinstance(obj, dict):
        write(_header(_MAP, len(obj)))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"msgpack: map keys must be str, not {type(key).__name__}")
            write(_str(key))
            if isinstance(value, (np.ndarray, torch.Tensor)) and _nbytes(value) > MAX_CHUNK_SIZE:
                value = _chunked(value)
            pack(value, write)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        for part in _ext(_EXT_NDARRAY, _array_parts(obj)):
            write(part)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (see :func:`pack`)."""
    parts: List[Any] = []
    pack(obj, parts.append)
    return b"".join(parts)
