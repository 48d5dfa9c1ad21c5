"""Flax's msgpack checkpoint format, read and written with the standard
library alone.

The JAX package saves parameter trees with
`flax.serialization.msgpack_serialize` (`to_bytes`), and its priors in
`artifacts/` are such files. This module reads them into nested dicts
and writes nested dicts back in the same bytes, without msgpack or flax:

- msgpack's nil, bool, int, float, str, bin, array, map and ext types,
  encoded as msgpack-python's packer encodes them (the smallest form of
  each; floats as float64; str as str8/16/32, bytes as bin);
- Flax's extension types: ndarray = 1 (the msgpack of (shape, dtype
  name, C-order buffer)), native_complex = 2 (the msgpack of (real,
  imag)) and npscalar = 3 (a 0-d ndarray, read back as a numpy scalar);
- Flax's chunked arrays: a leaf over MAX_CHUNK_SIZE bytes is stored as
  {"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
  {"0": flat part, ..}} and joined on read.

Arrays read as numpy arrays, except bfloat16 (numpy has no such dtype),
which reads as a torch.bfloat16 tensor of the same bits. Writing takes
numpy arrays and scalars, torch tensors (bfloat16 among them), Python
scalars, str, bytes, None, complex, lists, tuples and dicts.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

# the size above which a leaf is chunked (flax/serialization.py
# MAX_CHUNK_SIZE); module level so that a test can make it small
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_NATIVE_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_NAMES = {torch.bfloat16: "bfloat16"}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def text(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_value(code, bytes(self.take(n)))

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.text(self.unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self.ext(self.unpack(lengths[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False):
    """msgpack.unpackb(data, raw=raw) with Flax's extension types."""
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: extra bytes after the object")
    return out


def _array_from_bytes(data: bytes):
    shape, name, buffer = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_value(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == EXT_NATIVE_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        arr = _array_from_bytes(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(node: Dict[str, Any]):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    parts = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                tree[key] = _unchunk_tree(value)
    return tree


def restore(data: bytes):
    """flax.serialization.msgpack_restore: the tree the bytes hold."""
    return _unchunk_tree(unpackb(data))


def read(path: str):
    """The tree of a Flax msgpack file: nested dicts of numpy arrays
    (torch.bfloat16 tensors for bfloat16 leaves) and Python scalars."""
    with open(path, "rb") as f:
        return restore(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _head(n: int, fix: Tuple[int, int], forms) -> bytes:
    """The header of a sized object: the fix form where n fits, else the
    first of `forms` ((type byte, struct format, limit)) that holds it."""
    base, limit = fix
    if limit and n <= limit:
        return bytes([base | n])
    for byte, fmt, top in forms:
        if n <= top:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: object of size {n} is too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for byte, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes([byte]) + struct.pack(fmt, n)
    else:
        for byte, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes([byte]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: integer {n} out of range")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _head(n, (0, 0), ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                 (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code) + data


def _array_bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype in _TORCH_NAMES:
            name = _TORCH_NAMES[t.dtype]
            buf = t.view(torch.int16).numpy().tobytes("C")
        else:
            a = t.numpy()
            name, buf = a.dtype.name, a.tobytes("C")
        shape = tuple(t.shape)
    else:
        if arr.dtype.hasobject:
            raise ValueError("msgpack: object arrays cannot be written")
        name, buf, shape = arr.dtype.name, arr.tobytes("C"), arr.shape
    return packb((tuple(int(s) for s in shape), name, buf))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        out.append(_head(len(data), (0xA0, 0x1F),
                         ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                          (0xDB, ">I", 0xFFFFFFFF))) + data)
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        out.append(_head(len(data), (0, 0),
                         ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                          (0xC6, ">I", 0xFFFFFFFF))) + data)
    elif type(obj) in (list, tuple):
        out.append(_head(len(obj), (0x90, 0x0F),
                         ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        out.append(_head(len(obj), (0x80, 0x0F),
                         ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        out.append(_pack_ext(EXT_NDARRAY, _array_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj))))
    elif type(obj) is complex:
        out.append(_pack_ext(EXT_NATIVE_COMPLEX,
                             packb((obj.real, obj.imag))))
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack.packb(obj, default=Flax's extension packer,
    strict_types=True)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr) -> Dict[str, Any]:
    itemsize = (arr.element_size() if isinstance(arr, torch.Tensor)
                else arr.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(arr, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(tree):
    """A copy of the dicts of `tree` with its oversized array leaves
    chunked, as flax's _chunk_array_leaves_in_place does (dict values and
    the root only)."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            if isinstance(value, (np.ndarray, torch.Tensor)):
                out[key] = (_chunk(value) if _nbytes(value) > MAX_CHUNK_SIZE
                            else value)
            elif isinstance(value, dict):
                out[key] = _chunk_tree(value)
            else:
                out[key] = value
        return out
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def write(tree) -> bytes:
    """The bytes flax.serialization.msgpack_serialize gives for `tree`."""
    return packb(_chunk_tree(tree))


def save(path: str, tree) -> None:
    """Write `tree` to `path` (through a temporary file and a rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(write(tree))
    os.replace(tmp, path)


def count_leaves(tree) -> int:
    """The number of non-dict leaves of a nested dict."""
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1
