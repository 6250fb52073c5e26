"""Tile store: the LMDB + LZ4-frame data plane (port of ``rnagan_tpu/data/store.py``).

The reference reads one LMDB database per slide whose values are
LZ4-frame-compressed pickles of ``(tile_name, raw_bytes, shape)`` in BGR
(reference ``read_data.py:195-253``); keys are ascii integers plus a
``__keys__`` index entry (``patch_gen_grid.py:115-131``). The repo's native
library (``native/tilestore.cc``: LMDB file format, LZ4 frames, a threaded
bulk decoder) reads and writes them; this module binds it with ``ctypes``
under the JAX binding's signatures (``rnagan_tpu/data/store.py:36-73``).

The library is built on first use, with ``g++`` and the flags of
``native/Makefile`` called directly, into
``build/tilestore/libtilestore-<hash>.so`` at the repository root (the hash
covers the source and the flags); nothing is written into ``native/``.

Values are unpickled with :class:`TileUnpickler`, which resolves no global
at all: a tile is a tuple of a str, bytes and a tuple of ints, the key index
a list of bytes, and a pickle that names any class or function is refused.
A tile that does not decode is dropped (``None``), as the reference drops
corrupt entries.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import os
import pickle
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tilestore.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tilestore"
#: native/Makefile's CXXFLAGS, and -shared as its rule adds
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native", "-pthread", "-shared")

_P, _I64, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p
#: C entry point -> (restype, argtypes), as the JAX binding declares them
SIGNATURES = {
    "ts_lz4f_decompress": (_I64, [_C, _I64, _P, _I64]),
    "ts_lz4f_compress_bound": (_I64, [_I64]),
    "ts_lz4f_compress": (_I64, [_C, _I64, _P, _I64]),
    "ts_lmdb_open": (_P, [_C]),
    "ts_lmdb_close": (None, [_P]),
    "ts_lmdb_entries": (_I64, [_P]),
    "ts_lmdb_get": (_I64, [_P, _C, _I64, _P, _I64]),
    "ts_lmdb_keys": (_I64, [_P, _P, _I64]),
    "ts_lmdb_writer_create": (_P, [_C]),
    "ts_lmdb_writer_put": (ctypes.c_int, [_P, _C, _I64, _C, _I64]),
    "ts_lmdb_writer_close": (_I64, [_P]),
    "ts_lmdb_load_batch": (_I64, [_P, _C, _I64, _I64, _I64, _I64, _P, _P, ctypes.c_int]),
}

#: ``ts_lmdb_load_batch`` status: decoded, and "the native pickle scanner gave up"
_TILE_OK, _TILE_PYTHON = 0, 3


def build() -> Tuple[Path, float]:
    """Compile ``native/tilestore.cc`` unless this exact build exists;
    ``(library path, seconds spent compiling)``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtilestore-{digest}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    staged = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(staged), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        staged.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{res.stdout}")
    os.replace(staged, lib)  # atomic: a concurrent loader sees all of it or nothing
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def native_lib() -> ctypes.CDLL:
    """The bound tile-store library (built on first use, once per process)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


# ------------------------------------------------------------------- LZ4


def lz4f_compress(data: bytes) -> bytes:
    lib = native_lib()
    cap = lib.ts_lz4f_compress_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.ts_lz4f_compress(data, len(data), out, cap)
    if n < 0:
        raise RuntimeError(f"lz4f_compress failed: {n}")
    return ctypes.string_at(out, n)


def lz4f_decompress(data: bytes, hint: Optional[int] = None) -> bytes:
    lib = native_lib()
    cap = hint or max(4 * len(data), 1 << 16)
    for _ in range(8):
        out = ctypes.create_string_buffer(cap)
        n = lib.ts_lz4f_decompress(data, len(data), out, cap)
        if n >= 0:
            return ctypes.string_at(out, n)
        if n != -2:  # -2: the output did not fit
            raise RuntimeError("lz4f_decompress: malformed frame")
        cap *= 4
    raise RuntimeError("lz4f_decompress: output too large")


# ------------------------------------------------------------------- pickles


class TileUnpickler(pickle.Unpickler):
    """An unpickler that resolves no global: tuples, lists, str, bytes and
    ints load; a pickle that names any class or function is refused."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"refusing to load the global {module}.{name}")


def restricted_loads(data: bytes):
    return TileUnpickler(io.BytesIO(data)).load()


#: what a value that does not decode raises: a bad LZ4 frame, a refused or
#: broken pickle, a payload of the wrong structure or size
_DECODE_ERRORS = (RuntimeError, pickle.UnpicklingError, EOFError, ValueError, TypeError, IndexError)


def serialize_tile(name: str, image: np.ndarray) -> bytes:
    """The reference's value (``patch_gen_grid.py:117,141``): an LZ4-framed
    pickle of ``(name, raw bytes, shape)``, the array stored as given (the
    read path swaps BGR to RGB, ``read_data.py:241``)."""
    image = np.ascontiguousarray(image, np.uint8)
    return lz4f_compress(pickle.dumps((name, image.tobytes(), image.shape)))


def deserialize_tile(value: bytes) -> Optional[np.ndarray]:
    """The inverse, with the reference's BGR -> RGB flip at read time
    (``read_data.py:233-242``); None for an entry that does not decode."""
    try:
        _, raw, shape = restricted_loads(lz4f_decompress(bytes(value)))
        img = np.frombuffer(raw, dtype=np.uint8).reshape(shape)
    except _DECODE_ERRORS:
        return None
    return img[..., ::-1].copy()


# ------------------------------------------------------------------- store


class LMDBTileStore:
    """Read-only per-slide tile database (the data behind the reference's
    PatchDataset, ``read_data.py:195-253``), opened once (mmap)."""

    def __init__(self, path: str):
        self._lib = native_lib()
        self._h = self._lib.ts_lmdb_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open LMDB file: {path}")
        self.path = path

    def close(self):
        if self._h:
            self._lib.ts_lmdb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return int(self._lib.ts_lmdb_entries(self._h))

    def get_raw(self, key: bytes) -> Optional[bytes]:
        cap = 1 << 20
        for _ in range(6):
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.ts_lmdb_get(self._h, key, len(key), buf, cap)
            if n < 0:
                return None
            if n <= cap:
                return ctypes.string_at(buf, n)
            cap = int(n)
        return None

    def keys(self) -> List[bytes]:
        """Tile keys: the ``__keys__`` index entry (``patch_gen_grid.py:129-131``)
        when it decodes to a list of bytes, else a walk of the whole tree."""
        raw = self.get_raw(b"__keys__")
        if raw is not None:
            try:
                index = restricted_loads(lz4f_decompress(raw))
            except _DECODE_ERRORS:
                index = None
            if isinstance(index, (list, tuple)) and all(isinstance(k, bytes) for k in index):
                return list(index)
        need = int(self._lib.ts_lmdb_keys(self._h, None, 0))
        buf = ctypes.create_string_buffer(max(need, 1))
        self._lib.ts_lmdb_keys(self._h, buf, need)
        raw_bytes = ctypes.string_at(buf, need)
        out, off = [], 0
        while off < need:
            n = int.from_bytes(raw_bytes[off:off + 4], "little")
            key = raw_bytes[off + 4:off + 4 + n]
            off += 4 + n
            if key != b"__keys__":
                out.append(key)
        return out

    def get_tile(self, key: bytes) -> Optional[np.ndarray]:
        raw = self.get_raw(key)
        return None if raw is None else deserialize_tile(raw)

    def prewarm(self) -> int:
        """Read the backing file once, sequentially, into the OS page cache
        (a cold corpus is disk-seek-bound under random tile reads); the
        number of bytes read."""
        total = 0
        with open(self.path, "rb", buffering=0) as f:
            while chunk := f.read(8 << 20):
                total += len(chunk)
        return total

    def load_tiles_fixed(self, keys: Sequence[bytes], height: int, width: int,
                         nthreads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Decode tiles of a known shape into one (N, H, W, 3) uint8 RGB array
        with the native threaded decoder (lookup, LZ4, pickle payload, BGR ->
        RGB); an entry its pickle scanner leaves alone is unpickled here.
        Returns ``(array, ok)``; rows with ``ok`` False are corrupt, missing
        or mis-shaped."""
        n = len(keys)
        out = np.empty((n, height, width, 3), np.uint8)
        if n == 0:
            return out, np.zeros(0, bool)
        packed = b"".join(len(k).to_bytes(4, "little") + bytes(k) for k in keys)
        status = np.empty(n, np.uint8)
        rc = self._lib.ts_lmdb_load_batch(self._h, packed, len(packed), n, height, width,
                                          out.ctypes.data, status.ctypes.data, nthreads)
        if rc < 0:
            raise RuntimeError("ts_lmdb_load_batch: malformed key packing")
        for i in np.flatnonzero(status == _TILE_PYTHON):
            img = self.get_tile(keys[i])
            if img is not None and img.shape == (height, width, 3):
                out[i] = img
                status[i] = _TILE_OK
        return out, status == _TILE_OK

    def load_tiles(self, keys: Sequence[bytes]) -> Tuple[np.ndarray, List[bytes]]:
        """Decode tiles into one contiguous uint8 NHWC array, dropping the
        entries that do not decode (the collate filter of reference
        ``histopathology_gan.py:26-48``); the shape is the first decodable
        tile's. Returns ``(array, kept keys)``."""
        keys = list(keys)
        shape = next((img.shape for img in map(self.get_tile, keys) if img is not None), None)
        if shape is None:
            return np.zeros((0, 0, 0, 3), np.uint8), []
        tiles, ok = self.load_tiles_fixed(keys, shape[0], shape[1])
        return tiles[ok], [k for k, good in zip(keys, ok) if good]


class LMDBTileWriter:
    """Writes a reference-format tile database (``patch_gen_grid.py:92-133``):
    ascii-integer keys and the ``__keys__`` index, on :meth:`close`."""

    def __init__(self, path: str):
        self._lib = native_lib()
        self._h = self._lib.ts_lmdb_writer_create(path.encode())
        self._count = 0
        self.path = path

    def put_tile(self, name: str, image: np.ndarray) -> int:
        key = str(self._count).encode("ascii")
        self.put_raw(key, serialize_tile(name, image))
        self._count += 1
        return self._count - 1

    def put_raw(self, key: bytes, value: bytes) -> None:
        if self._lib.ts_lmdb_writer_put(self._h, key, len(key), value, len(value)) != 0:
            raise RuntimeError("writer_put failed")

    def close(self) -> int:
        keys = [str(i).encode("ascii") for i in range(self._count)]
        self.put_raw(b"__keys__", lz4f_compress(pickle.dumps(keys)))
        n = int(self._lib.ts_lmdb_writer_close(self._h))
        self._h = None
        if n < 0:
            raise IOError(f"failed writing {self.path}")
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._h:
            self.close()
